"""Device-resident whole-slide program: patch pixels -> gene predictions with
no host round trip.

Counterpart of ``sequoia_tpu/pipeline/fused.py``:

    patch batches -> backbone features (stay on the device)
    -> kmeans++/Lloyd -> per-cluster mean features (NaN means zeroed)
    -> ViS forward -> (num_genes,) predictions

``backbone="resnet"`` is ResNet-50 (2048-d), ``"uni"`` the bit-exact Pillow
bilinear resize to 224 + ViT-L/16 (1024-d, the full default
``UniViTConfig``), ``"virchow2"`` the bicubic resize + Virchow2's ViT-H/14
(2560-d, the full default ``Virchow2Config``); a ViT's weights are cast to
the compute dtype once.  All-zero patches are padding and
are masked out of clustering.  ``kernels=True`` runs the kernel
configuration: ResNet ``early_pallas`` (K2/K3), k-means ``use_pallas`` (K5
in every Lloyd step) and the fused ViS block stack (K1) where
``cuda_vis.kernel_takes`` accepts the ViS config (UNI's reference ViS,
input_dim 1024 against 2P = 2048, and Virchow2's at 2560 do not fit the
packed layout).  It is
off by default, as the JAX program runs none of its kernels.
"""

from __future__ import annotations

import torch

from sequoia_tpu_torch.models import resnet, uni_vit, vis
from sequoia_tpu_torch.ops import cuda_vis
from sequoia_tpu_torch.ops import kmeans as km
from sequoia_tpu_torch.ops.nn import compute_dtype as _dtype
from sequoia_tpu_torch.ops.nn import precision
from sequoia_tpu_torch.pipeline.features import FEAT_TYPES, vit_config
from sequoia_tpu_torch.utils.device import resolve_device, tree_to


def make_slide_program(backbone_params, vis_cfg: vis.ViSConfig, vis_params, *,
                       n_clusters: int = 100, compute_dtype=torch.bfloat16,
                       backbone: str = "resnet", kernels: bool = False, device=None):
    """Returns ``run(patch_batches_u8, gen) -> (num_genes,)``.

    ``patch_batches_u8``: (n_batches, B, H, W, 3) uint8; ``gen``: a
    ``torch.Generator`` on the program's device, seeding kmeans++."""
    if backbone not in FEAT_TYPES:
        raise ValueError(f"backbone must be one of {FEAT_TYPES}, got {backbone!r}")
    dev = resolve_device(device)
    dt = precision(compute_dtype)
    params = tree_to(backbone_params, dev)
    if backbone == "resnet":
        rcfg = resnet.ResNetConfig(compute_dtype=dt, early_pallas=kernels)

        def one_batch(u8):
            return resnet.extract_from_uint8(rcfg, params, u8)
    else:
        ucfg = vit_config(backbone, compute_dtype=dt)
        params = uni_vit.prepare(ucfg, params)

        def one_batch(u8):
            return uni_vit.extract_from_uint8(ucfg, params, u8)
    vparams = tree_to(vis_params, dev)
    vdt = _dtype(vis_cfg.compute_dtype)
    packed = (cuda_vis.pack_vis_blocks(vis_cfg, vparams, vdt)
              if kernels and cuda_vis.kernel_takes(vis_cfg, vdt)[0] else None)

    @torch.no_grad()
    def run(patch_batches_u8, gen: torch.Generator) -> torch.Tensor:
        batches = torch.as_tensor(patch_batches_u8).to(dev)
        feats, valid = [], []
        for u8 in batches:
            # all-zero patches are padding: masked out of clustering
            valid.append((u8 != 0).flatten(1).any(1))
            feats.append(one_batch(u8))
        feats, mask = torch.cat(feats), torch.cat(valid)
        _, labels, _, _ = km.kmeans_fit(feats, mask, gen, n_clusters=n_clusters,
                                        use_pallas=kernels)
        # fewer valid patches than clusters leaves NaN means: zero them
        cf = torch.nan_to_num(km.cluster_means(feats, labels, mask, n_clusters))
        if packed is not None:
            return cuda_vis.vis_apply_fused(vis_cfg, vparams, packed, cf[None])[0]
        return vis.apply(vis_cfg, vparams, cf[None])[0]

    return run
