"""Batched backbone features with fused preprocessing: uint8 patches ->
per-patch embeddings.

Counterpart of ``sequoia_tpu/pipeline/features.py:34-144`` (the in-memory
``FeatureExtractor``).  Patches travel to the device as uint8 in fixed
``batch_size`` blocks, the tail block zero-padded to the full batch; the
preprocessing runs on the device with the backbone (the ImageNet
normalization, and for UNI first the bit-exact Pillow resize to 224).
``raw_fwd`` is the backbone as one ``(params, u8) -> (N, D)`` function
honouring ``cfg``, so a caller can run more device work on the same
uploaded batch (serving's tissue screen,
``serve.SlidePredictor._fused_program``).  The mesh (multi-device) mode and
the HDF5 feature stage (``compute_features``) are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from sequoia_tpu_torch.models import resnet as resnet_mod
from sequoia_tpu_torch.models import uni_vit
from sequoia_tpu_torch.ops.nn import precision
from sequoia_tpu_torch.utils.device import resolve_device, tree_to


class FeatureExtractor:
    """uint8 patches -> backbone features.

    ``feat_type="resnet"``: normalize 256-px patches -> ResNet-50 -> 2048-d;
    ``cfg.early_pallas`` / ``fused_stages`` switch the ResNet kernels on.
    ``feat_type="uni"``: resize to 224 (bit-exact Pillow BILINEAR, the
    reference's PIL ``Resize(224)``) -> ViT-L/16 -> 1024-d, the weights cast
    to the compute dtype once here.  ``params``: the port's parameters for
    that backbone (moved to ``device``).  The compute dtype comes from
    ``cfg`` or ``compute_dtype`` (f32 by default)."""

    #: UNI batches run through the ViT in chunks of this many patches where
    #: the batch is larger and a multiple of it (0: never); the upload
    #: granularity stays ``batch_size``.  The value is the H100's, from the
    #: chunk sweep of ``chip_smoke.py``'s ``uni_path`` (PERF.md).
    UNI_SCAN_CHUNK = 0

    def __init__(self, feat_type: str, params, batch_size: int = 256,
                 compute_dtype=None, patch_size: int = 256, cfg=None, mesh=None,
                 device=None):
        if feat_type not in ("resnet", "uni"):
            raise ValueError('feat_type must be "resnet" or "uni"')
        if mesh is not None:
            raise NotImplementedError("mesh (multi-device) extraction is not ported "
                                      "yet (ROADMAP.md)")
        if (cfg is not None and compute_dtype is not None
                and precision(cfg.compute_dtype) != precision(compute_dtype)):
            raise ValueError(f"cfg.compute_dtype={cfg.compute_dtype} conflicts with "
                             f"compute_dtype={compute_dtype}; set it on the cfg")
        self.device = resolve_device(device)
        self.feat_type = feat_type
        self.batch_size = batch_size
        self.patch_size = patch_size
        dt = precision(compute_dtype if cfg is None else cfg.compute_dtype)
        if feat_type == "resnet":
            self.cfg = cfg or resnet_mod.ResNetConfig(compute_dtype=dt)
            self.feature_dim = self.cfg.feature_dim_for(patch_size, patch_size)
            self.params = tree_to(params, self.device)
        else:
            self.cfg = cfg or uni_vit.UniViTConfig(compute_dtype=dt)
            self.feature_dim = self.cfg.dim
            self.params = uni_vit.prepare(self.cfg, tree_to(params, self.device))

    def upload(self, block_u8: np.ndarray) -> torch.Tensor:
        """Host block -> the extractor's device."""
        return torch.as_tensor(block_u8).to(self.device, non_blocking=True)

    def raw_fwd(self, params, u8: torch.Tensor) -> torch.Tensor:
        """(N, ps, ps, 3) uint8 on the device -> (N, D) f32 features through
        ``cfg`` (its kernel options included); UNI in chunks of
        :attr:`UNI_SCAN_CHUNK`."""
        if self.feat_type == "resnet":
            return resnet_mod.extract_from_uint8(self.cfg, params, u8)
        n, ck = u8.shape[0], self.UNI_SCAN_CHUNK
        if ck and n > ck and n % ck == 0:
            return torch.cat([uni_vit.extract_from_uint8(self.cfg, params, u8[s:s + ck])
                              for s in range(0, n, ck)])
        return uni_vit.extract_from_uint8(self.cfg, params, u8)

    @torch.no_grad()
    def features(self, patches_u8) -> torch.Tensor:
        """(N, ps, ps, 3) uint8 (numpy or tensor) -> (N, D) f32 on the
        device, in ``batch_size`` blocks with the tail padded."""
        n, bs = patches_u8.shape[0], self.batch_size
        out = torch.empty((n, self.feature_dim), dtype=torch.float32, device=self.device)
        for start in range(0, n, bs):
            block = patches_u8[start:start + bs]
            if not isinstance(block, torch.Tensor):
                block = self.upload(np.ascontiguousarray(block))
            block = block.to(self.device)
            m = block.shape[0]
            if m < bs:  # pad the tail to the full batch shape
                pad = torch.zeros((bs - m,) + tuple(block.shape[1:]), dtype=block.dtype,
                                  device=block.device)
                block = torch.cat([block, pad])
            feats = self.raw_fwd(self.params, block)
            out[start:start + m] = feats[:m]
        return out

    def __call__(self, patches_u8) -> np.ndarray:
        """(N, ps, ps, 3) uint8 -> (N, D) f32 numpy."""
        return self.features(patches_u8).cpu().numpy()
