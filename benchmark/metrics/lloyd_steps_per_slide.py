"""Lloyd steps a slide: the program's ``kmeans.lloyd_steps`` counter over the
count of its ``serve.kmeans`` spans, from
``sequoia_tpu_torch.utils.profiling.summary()`` in the run's own process.

Layer: k-means; source: program_counter; unit: steps, lower is better;
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
    steps = s["counters"].get("kmeans.lloyd_steps")
    return steps / slides if steps is not None and slides else None
