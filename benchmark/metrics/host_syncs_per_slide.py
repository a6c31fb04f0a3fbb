"""Host syncs a slide: the program's ``host_syncs`` counter (each call on the
serving path that blocks the host on the device: the Lloyd steps' reads,
kmeans++'s draws, blocking uploads, the genes' readback) over the count of
its ``serve.kmeans`` spans, from
``sequoia_tpu_torch.utils.profiling.summary()`` in the run's own process.

Layer: serving; source: program_counter; unit: syncs, lower is better;
moves slides_per_hour."""


def read(rec: dict):
    if not rec.get("trace"):
        return None
    from sequoia_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)  # a program without the recorder
    if summary is None:
        return None
    s = summary()
    slides = s["spans"].get("serve.kmeans", {}).get("count", 0)
    syncs = s["counters"].get("host_syncs")
    return syncs / slides if syncs is not None and slides else None
