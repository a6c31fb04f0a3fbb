"""The host's milliseconds to issue one training step: the host time of the
program's ``train.step`` spans (forward, backward and AdamW launched, no
synchronise) over their count, from
``sequoia_tpu_torch.utils.profiling.summary()`` in the run's own process.

Layer: train step; source: program_span; unit: ms, lower is better;
moves train_slides_per_s."""


def read(rec: dict):
    if not rec.get("trace"):
        return None
    from sequoia_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)  # a program without the recorder
    if summary is None:
        return None
    step = summary()["spans"].get("train.step")
    return step["host_ms"] / step["count"] if step and step["count"] else None
