"""Backbone kind ``virchow2``: Virchow2's ViT-H/14 (Zimmermann et al.,
arXiv:2408.00738; timm ``vit_huge_patch14_224`` with 4 register tokens and
a packed SwiGLU MLP), the (B, 2 D) CLS ⊕ patch-mean features after Pillow's
bicubic resize of each uint8 patch to ``img_size``.

A kind's file gives ``weights``, ``extractor``, ``reference`` and ``work``,
as ``benchmark.serving.backbone_kind`` says.  The configuration's
``backbone`` group ``b`` holds ``patch_size``, ``img_size``, ``patch``,
``dim``, ``feature_dim`` (2 ``dim``), ``depth``, ``heads``, ``mlp_dim``
(fc1's width; fc2 takes half of it), ``reg_tokens``, ``layer_scale``,
``batch_size`` and ``compute_dtype``."""

from __future__ import annotations

import torch

from benchmark import arith
from benchmark import weights as seeded
from benchmark.reference import virchow2 as ref


def _shape(b: dict) -> dict:
    g = b["img_size"] // b["patch"]
    return {"grid": g * g, "tokens": g * g + 1 + b["reg_tokens"],
            "pdim": b["patch"] * b["patch"] * 3, "dim": b["dim"], "depth": b["depth"],
            "mlp": b["mlp_dim"], "hid": b["mlp_dim"] // 2, "reg": b["reg_tokens"]}


def weights(b: dict, gen: torch.Generator) -> dict:
    """timm's shapes; GEMM weights normal with the fan-in's inverse root as
    their deviation, biases zero, LayerNorms 1 and 0, the CLS and register
    tokens and the position embedding normal at 0.02, every LayerScale
    gamma ``layer_scale``; drawn on ``gen``'s device in the program's
    layout."""
    s = _shape(b)
    dev, d, depth, mlp, hid = gen.device, s["dim"], s["depth"], s["mlp"], s["hid"]
    shapes = [(s["pdim"], d), (1, d), (s["reg"], d), (s["tokens"], d), (depth, d, 3 * d),
              (depth, d, d), (depth, d, mlp), (depth, hid, d)]
    flat = seeded._Flat(gen, shapes, "normal")

    def full(shape, v):
        return torch.full(shape, float(v), device=dev)

    ls = b["layer_scale"]
    params = {"patch_w": flat.take(shapes[0], s["pdim"] ** -0.5), "patch_b": full((d,), 0),
              "cls_token": flat.take(shapes[1], 0.02), "reg_token": flat.take(shapes[2], 0.02),
              "pos_emb": flat.take(shapes[3], 0.02),
              "norm_scale": full((d,), 1), "norm_bias": full((d,), 0)}
    params["blocks"] = {
        "ln1_scale": full((depth, d), 1), "ln1_bias": full((depth, d), 0),
        "w_qkv": flat.take(shapes[4], d ** -0.5), "b_qkv": full((depth, 3 * d), 0),
        "w_proj": flat.take(shapes[5], d ** -0.5), "b_proj": full((depth, d), 0),
        "ls1": full((depth, d), ls),
        "ln2_scale": full((depth, d), 1), "ln2_bias": full((depth, d), 0),
        "w_fc1": flat.take(shapes[6], d ** -0.5), "b_fc1": full((depth, mlp), 0),
        "w_fc2": flat.take(shapes[7], hid ** -0.5), "b_fc2": full((depth, d), 0),
        "ls2": full((depth, d), ls)}
    return params


def extractor(b: dict, params: dict, on: list[str], device):
    """``cli/serve.build_extractor``'s Virchow2; ``on`` without K4
    (``bottleneck_chain``), which runs only in a ResNet.  A program without
    the backbone raises ``ValueError`` here."""
    from sequoia_tpu_torch.models import uni_vit
    from sequoia_tpu_torch.ops.nn import compute_dtype
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor

    config = getattr(uni_vit, "Virchow2Config", None)
    if config is None:
        raise ValueError("backbone kind 'virchow2': the program has no Virchow2Config")
    cfg = config(img_size=b["img_size"], patch_size=b["patch"], dim=b["dim"],
                 depth=b["depth"], heads=b["heads"], mlp_dim=b["mlp_dim"],
                 reg_tokens=b["reg_tokens"], compute_dtype=compute_dtype(b["compute_dtype"]))
    return (FeatureExtractor("virchow2", params, batch_size=b["batch_size"], cfg=cfg,
                             device=device, patch_size=b["patch_size"]),
            [k for k in on if k != "bottleneck_chain"])


def reference(b: dict, params: dict, u8, device, mode: str) -> torch.Tensor:
    """(B, H, W, 3) uint8, on the host or the device -> (B, 2 D) f32; the
    resize is Pillow's, on the host."""
    if torch.is_tensor(u8):
        u8 = u8.cpu().numpy()
    return ref.features(params, u8, img=b["img_size"], patch=b["patch"], heads=b["heads"],
                        device=device, mode=mode)


def macs(b: dict) -> int:
    """Multiply-accumulates of one forward: the patch embedding, then per
    block qkv, q.k^T, attention x V, the output projection, fc1 and fc2 (the
    gate, the softmax and the LayerNorms are not counted, as
    ``arith.vit_macs`` counts UNI)."""
    s = _shape(b)
    n, d = s["tokens"], s["dim"]
    block = n * d * 3 * d + 2 * n * n * d + n * d * d + n * d * s["mlp"] + n * s["hid"] * d
    return s["grid"] * s["pdim"] * d + s["depth"] * block


def n_params(b: dict) -> int:
    s = _shape(b)
    d, mlp, hid = s["dim"], s["mlp"], s["hid"]
    block = 4 * d * d + 3 * d + d + d * mlp + mlp + hid * d + d + 6 * d
    return (s["pdim"] * d + d + d + s["reg"] * d + s["tokens"] * d + s["depth"] * block
            + 2 * d)


def work(b: dict, n: int) -> tuple[dict, float]:
    """(flops by dtype, bytes) of the extractor over ``n`` uint8 patches of
    ``patch_size`` px in batches of ``batch_size`` (the tail padded, as the
    extractor runs it): the GEMM and attention products in the compute
    dtype; the uint8 in, the f32 features out, the weights once a batch."""
    dt, bs, size = b["compute_dtype"], b["batch_size"], b["patch_size"]
    n_run = -(-n // bs) * bs
    nbytes = (n * size * size * 3 + n * b["feature_dim"] * 4
              + (n_run // bs) * n_params(b) * arith.BYTES[dt])
    return {dt: 2.0 * macs(b) * n_run}, float(nbytes)
