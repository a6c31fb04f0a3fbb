"""Backbone kind ``uni_vitl16``: UNI's ViT-L/16 (Chen et al., Nat. Med.
2024; timm ``vit_large_patch16_224``), the CLS token's (B, D) features
after Pillow's bilinear resize of each uint8 patch to ``img_size``.

A kind's file gives ``weights``, ``extractor``, ``reference`` and ``work``,
as ``benchmark.serving.backbone_kind`` says.  The configuration's
``backbone`` group ``b`` holds ``patch_size``, ``img_size``, ``patch``,
``feature_dim``, ``depth``, ``heads``, ``mlp_dim``, ``layer_scale``,
``batch_size`` and ``compute_dtype``."""

from __future__ import annotations

import torch

from benchmark import arith
from benchmark import weights as seeded
from benchmark.reference import uni_vitl16 as ref


def weights(b: dict, gen: torch.Generator) -> dict:
    """Normal GEMM weights at the fan-in's inverse root, every LayerScale
    gamma ``layer_scale`` (``weights.uni_vit``)."""
    return seeded.uni_vit(gen, img=b["img_size"], patch=b["patch"], dim=b["feature_dim"],
                          depth=b["depth"], mlp=b["mlp_dim"], layer_scale=b["layer_scale"])


def extractor(b: dict, params: dict, on: list[str], device):
    """``cli/serve.build_extractor``'s UNI; ``on`` without K4
    (``bottleneck_chain``), which runs only in a ResNet."""
    from sequoia_tpu_torch.models import uni_vit
    from sequoia_tpu_torch.ops.nn import compute_dtype
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor

    cfg = uni_vit.UniViTConfig(img_size=b["img_size"], patch_size=b["patch"],
                               dim=b["feature_dim"], depth=b["depth"], heads=b["heads"],
                               mlp_dim=b["mlp_dim"],
                               compute_dtype=compute_dtype(b["compute_dtype"]))
    return (FeatureExtractor("uni", params, batch_size=b["batch_size"], cfg=cfg, device=device,
                             patch_size=b["patch_size"]),
            [k for k in on if k != "bottleneck_chain"])


def reference(b: dict, params: dict, u8, device, mode: str) -> torch.Tensor:
    """(B, H, W, 3) uint8, on the host or the device -> (B, D) f32; the
    resize is Pillow's, on the host."""
    if torch.is_tensor(u8):
        u8 = u8.cpu().numpy()
    return ref.features(params, u8, img=b["img_size"], patch=b["patch"], heads=b["heads"],
                        device=device, mode=mode)


def work(b: dict, n: int) -> tuple[dict, float]:
    return arith.vit_work(n, b["patch_size"], b["batch_size"], b["compute_dtype"],
                          img=b["img_size"], patch=b["patch"], dim=b["feature_dim"],
                          depth=b["depth"], mlp=b["mlp_dim"])
