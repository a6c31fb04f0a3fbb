"""The training loop's wait for a batch: the host time of the program's
``train.batch_wait`` spans (the loop blocked on the prefetch thread's queue;
one a batch and one at the end of each phase) over their count, from
``sequoia_tpu_torch.utils.profiling.summary()`` in the run's own process.

Layer: train loop phases; source: program_span; unit: ms, lower is better;
moves train_slides_per_s."""


def read(rec: dict):
    if not rec.get("trace"):
        return None
    from sequoia_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)  # a program without the recorder
    if summary is None:
        return None
    wait = summary()["spans"].get("train.batch_wait")
    return wait["host_ms"] / wait["count"] if wait and wait["count"] else None
