"""ViT attention milliseconds per thousand patches: the device time (CUDA
events) of the program's ``vit.attn`` spans (each block's attention between
the qkv GEMM and the proj GEMM: the head split, scores, softmax, P.V and
head merge, one ``vit_attention`` kernel launch on the card) over the
patches of the slides the profiler traced, from
``sequoia_tpu_torch.utils.profiling.summary()`` in the run's own process
(the spans record only while the traced window's profiler runs, so the
untraced slides' patches are not counted).  A program without the span
gives nothing.

Layer: backbone; source: program_span; unit: ms, lower is better;
moves slides_per_hour."""


def read(rec: dict):
    if not rec.get("trace"):
        return None
    from sequoia_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)  # a program without the recorder
    if summary is None:
        return None
    attn = summary()["spans"].get("vit.attn")
    k = rec["items"].get("patches_traced", 0) / 1000.0
    return attn["device_ms"] / k if attn and k else None
