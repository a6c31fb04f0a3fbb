"""ViT MLP milliseconds per thousand patches: the device time (CUDA events)
of the program's ``vit.mlp`` spans (each block's MLP branch: LayerNorm,
fc1, the GELU or SwiGLU gate, fc2 and LayerScale) over the patches of the
slides the profiler traced, from ``sequoia_tpu_torch.utils.profiling.
summary()`` in the run's own process (the spans record only while the
traced window's profiler runs, so the untraced slides' patches are not
counted).

Layer: backbone; source: program_span; unit: ms, lower is better;
moves slides_per_hour."""


def read(rec: dict):
    if not rec.get("trace"):
        return None
    from sequoia_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)  # a program without the recorder
    if summary is None:
        return None
    mlp = summary()["spans"].get("vit.mlp")
    k = rec["items"].get("patches_traced", 0) / 1000.0
    return mlp["device_ms"] / k if mlp and k else None
