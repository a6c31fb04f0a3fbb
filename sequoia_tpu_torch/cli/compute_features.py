"""Backbone loading for the feature-extraction and serving entry points.

Counterpart of ``sequoia_tpu/cli/compute_features.py:24-60``
(``load_extractor``).  ``weights`` is a torch state dict (``.pt``/``.bin``,
torchvision's ResNet-50 names) or ``"random"`` (random ResNet-50 weights
from seed 0, for benchmarks and smoke runs).  The UNI backbone and data
parallelism are not ported yet (ROADMAP.md queue 1 items 3 and 8); this
module's ``main``, the HDF5 feature stage, waits for item 6.
"""

from __future__ import annotations

import torch

from sequoia_tpu_torch.models import resnet
from sequoia_tpu_torch.ops.nn import compute_dtype as to_dtype
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.train import checkpoint


def load_extractor(feat_type: str, weights: str, batch_size: int,
                   compute_dtype: str = "float32", data_parallel: bool = False, *,
                   device=None, fused_stages: tuple[int, ...] = ()) -> FeatureExtractor:
    """A :class:`FeatureExtractor` on ``device`` (CUDA unless given, as every
    entry point), ``fused_stages`` running those ResNet stages' stride-1
    blocks through the K4 kernel."""
    if feat_type == "uni":
        raise NotImplementedError("feat_type 'uni' is not ported yet (ROADMAP.md queue 1 "
                                  "item 3)")
    if feat_type != "resnet":
        raise ValueError('feat_type must be "resnet" or "uni"')
    if data_parallel:
        raise NotImplementedError("data_parallel is not ported yet (ROADMAP.md queue 1 "
                                  "item 8)")
    if weights == "random":
        params = resnet.random_params(torch.Generator().manual_seed(0))
    else:
        params = resnet.resnet50_from_torch(checkpoint.load_torch_checkpoint(weights))
    cfg = resnet.ResNetConfig(compute_dtype=to_dtype(compute_dtype),
                              fused_stages=tuple(fused_stages))
    return FeatureExtractor(feat_type, params, batch_size=batch_size, cfg=cfg, device=device)
