"""ViT preprocessing milliseconds per thousand patches: the device time
(CUDA events) of the program's ``vit.preprocess`` spans (the Pillow-exact
resize of the uint8 patches and the ImageNet normalisation) over the
patches of the slides the profiler traced, from
``sequoia_tpu_torch.utils.profiling.summary()`` in the run's own process
(the spans record only while the traced window's profiler runs).

Layer: backbone; source: program_span; unit: ms, lower is better;
moves slides_per_hour."""


def read(rec: dict):
    if not rec.get("trace"):
        return None
    from sequoia_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)  # a program without the recorder
    if summary is None:
        return None
    pre = summary()["spans"].get("vit.preprocess")
    k = rec["items"].get("patches_traced", 0) / 1000.0
    return pre["device_ms"] / k if pre and k else None
