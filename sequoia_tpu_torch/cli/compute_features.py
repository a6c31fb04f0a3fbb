"""Backbone loading for the feature-extraction and serving entry points.

Counterpart of ``sequoia_tpu/cli/compute_features.py:24-60``
(``load_extractor``).  ``weights`` is a local torch state dict
(``.pt``/``.bin``: torchvision's ResNet-50 names, or timm's ViT names for
UNI, e.g. the MahmoodLab UNI ``pytorch_model.bin``) or ``"random"`` (random
weights from seed 0, for benchmarks and smoke runs); nothing is downloaded.
A UNI state dict gives its own config (``uni_vit.uni_from_torch``), with
``compute_dtype`` applied to it.  Data parallelism is not ported yet
(ROADMAP.md queue 1 item 8); this module's ``main``, the HDF5 feature
stage, waits for item 6.
"""

from __future__ import annotations

import dataclasses

import torch

from sequoia_tpu_torch.models import resnet, uni_vit
from sequoia_tpu_torch.ops.nn import compute_dtype as to_dtype
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.train import checkpoint


def load_extractor(feat_type: str, weights: str, batch_size: int,
                   compute_dtype: str = "float32", data_parallel: bool = False, *,
                   device=None, fused_stages: tuple[int, ...] = ()) -> FeatureExtractor:
    """A :class:`FeatureExtractor` on ``device`` (CUDA unless given, as every
    entry point), ``fused_stages`` running those ResNet stages' stride-1
    blocks through the K4 kernel (a ResNet option only)."""
    if feat_type not in ("resnet", "uni"):
        raise ValueError('feat_type must be "resnet" or "uni"')
    if data_parallel:
        raise NotImplementedError("data_parallel is not ported yet (ROADMAP.md queue 1 "
                                  "item 8)")
    dtype = to_dtype(compute_dtype)
    if feat_type == "uni":
        if fused_stages:
            raise ValueError("fused_stages is a ResNet option; the UNI backbone has none")
        if weights == "random":
            cfg = uni_vit.UniViTConfig()
            params = uni_vit.random_params(cfg, torch.Generator().manual_seed(0))
        else:
            # the cfg inferred from the state dict, not the default shape
            cfg, params = uni_vit.uni_from_torch(checkpoint.load_torch_checkpoint(weights))
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
        return FeatureExtractor(feat_type, params, batch_size=batch_size, cfg=cfg,
                                device=device)
    if weights == "random":
        params = resnet.random_params(torch.Generator().manual_seed(0))
    else:
        params = resnet.resnet50_from_torch(checkpoint.load_torch_checkpoint(weights))
    cfg = resnet.ResNetConfig(compute_dtype=dtype, fused_stages=tuple(fused_stages))
    return FeatureExtractor(feat_type, params, batch_size=batch_size, cfg=cfg, device=device)
