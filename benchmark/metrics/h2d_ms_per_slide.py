"""Host-to-device copy milliseconds a slide: the device time of the
profiler's ``Memcpy HtoD`` operations over the traced slides (the patch or
feature uploads that ``SlidePredictor.io_stats["bytes_uploaded"]``
counts).

Layer: serving uploads; source: device_trace; unit: ms, lower is better;
moves slides_per_hour."""


def read(rec: dict):
    tr = rec.get("trace")
    n = rec["items"].get("slides_traced", 0)
    return 1e3 * tr["h2d_s"] / n if tr and n and tr["h2d_s"] > 0 else None
