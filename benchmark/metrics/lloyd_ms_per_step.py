"""Lloyd milliseconds a step: the device time (CUDA events) of the program's
``kmeans.lloyd`` spans (the step loop of each fit, with the K5 plan its
steps share) over its ``kmeans.lloyd_steps`` counter, from
``sequoia_tpu_torch.utils.profiling.summary()`` in the run's own process.

Layer: k-means; source: program_span; unit: ms, lower is better;
moves slides_per_hour."""


def read(rec: dict):
    if not rec.get("trace"):
        return None
    from sequoia_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)  # a program without the recorder
    if summary is None:
        return None
    s = summary()
    lloyd = s["spans"].get("kmeans.lloyd")
    steps = s["counters"].get("kmeans.lloyd_steps", 0)
    return lloyd["device_ms"] / steps if lloyd and steps else None
