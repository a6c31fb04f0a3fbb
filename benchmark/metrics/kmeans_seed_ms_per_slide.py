"""kmeans++ seeding milliseconds a slide: the device time (CUDA events) of
the program's ``kmeans.seed`` spans over the count of its ``serve.kmeans``
spans, from ``sequoia_tpu_torch.utils.profiling.summary()`` in the run's
own process (the recorder holds what the traced window's profiler saw).

Layer: k-means; source: program_span; unit: ms, lower is better;
moves slides_per_hour."""


def read(rec: dict):
    if not rec.get("trace"):
        return None
    from sequoia_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)  # a program without the recorder
    if summary is None:
        return None
    spans = summary()["spans"]
    slides = spans.get("serve.kmeans", {}).get("count", 0)
    seed = spans.get("kmeans.seed")
    return seed["device_ms"] / slides if seed and slides else None
