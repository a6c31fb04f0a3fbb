"""Backbone kind ``resnet50``: torchvision's ResNet-50 (He et al. 2016) as
SEQUOIA extracts features with it, (B, 2048) from 256-px uint8 patches.

A kind's file gives ``weights``, ``extractor``, ``reference`` and ``work``,
as ``benchmark.serving.backbone_kind`` says.  The configuration's
``backbone`` group ``b`` holds ``patch_size``, ``batch_size``,
``compute_dtype`` and ``feature_dim``."""

from __future__ import annotations

import torch

from benchmark import arith
from benchmark import weights as seeded
from benchmark.reference import resnet50 as ref


def weights(b: dict, gen: torch.Generator) -> dict:
    """He-normal convolutions and identity BatchNorm (``weights.resnet50``)."""
    return seeded.resnet50(gen)


def extractor(b: dict, params: dict, on: list[str], device):
    """``cli/serve.build_extractor``'s ResNet: K4 in ``K4_STAGES`` where
    ``bottleneck_chain`` is in ``on``, the space-to-depth stem; ``on`` as
    it is (this kind runs every serving kernel)."""
    from sequoia_tpu_torch.cli.compute_features import K4_STAGES
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.ops.nn import compute_dtype
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor

    cfg = resnet.ResNetConfig(compute_dtype=compute_dtype(b["compute_dtype"]),
                              fused_stages=K4_STAGES if "bottleneck_chain" in on else ())
    return FeatureExtractor("resnet", resnet.enable_s2d_stem(params), batch_size=b["batch_size"],
                            cfg=cfg, device=device, patch_size=b["patch_size"]), list(on)


def reference(b: dict, params: dict, u8, device, mode: str) -> torch.Tensor:
    """(B, H, W, 3) uint8, on the host or the device -> (B, 2048) f32."""
    return ref.features(params, torch.as_tensor(u8, device=device), mode)


def work(b: dict, n: int) -> tuple[dict, float]:
    return arith.resnet50_work(n, b["patch_size"], b["batch_size"], b["compute_dtype"])
