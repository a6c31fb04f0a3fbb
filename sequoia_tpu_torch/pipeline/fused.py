"""Device-resident whole-slide program: patch pixels -> gene predictions with
no host round trip.

Counterpart of ``sequoia_tpu/pipeline/fused.py`` (``backbone="resnet"``):

    patch batches -> ResNet-50 features (stay on the device)
    -> kmeans++/Lloyd -> per-cluster mean features (NaN means zeroed)
    -> ViS forward -> (num_genes,) predictions

All-zero patches are padding and are masked out of clustering.
``kernels=True`` runs the slice's kernel configuration: ResNet
``early_pallas`` (K2/K3), k-means ``use_pallas`` (K5 in every Lloyd step)
and the fused ViS block stack (K1).  It is off by default, as the JAX
program runs none of its kernels.
"""

from __future__ import annotations

import torch

from sequoia_tpu_torch.models import resnet, vis
from sequoia_tpu_torch.ops import cuda_vis
from sequoia_tpu_torch.ops import kmeans as km
from sequoia_tpu_torch.ops.nn import compute_dtype as _dtype
from sequoia_tpu_torch.ops.nn import precision
from sequoia_tpu_torch.utils.device import resolve_device, tree_to


def make_slide_program(backbone_params, vis_cfg: vis.ViSConfig, vis_params, *,
                       n_clusters: int = 100, compute_dtype=torch.bfloat16,
                       backbone: str = "resnet", kernels: bool = False, device=None):
    """Returns ``run(patch_batches_u8, gen) -> (num_genes,)``.

    ``patch_batches_u8``: (n_batches, B, H, W, 3) uint8; ``gen``: a
    ``torch.Generator`` on the program's device, seeding kmeans++."""
    if backbone == "uni":
        raise NotImplementedError("backbone='uni' is not ported yet (ROADMAP.md)")
    if backbone != "resnet":
        raise ValueError('backbone must be "resnet" or "uni"')
    dev = resolve_device(device)
    rcfg = resnet.ResNetConfig(compute_dtype=precision(compute_dtype),
                               early_pallas=kernels)
    params = tree_to(backbone_params, dev)
    vparams = tree_to(vis_params, dev)
    packed = (cuda_vis.pack_vis_blocks(vis_cfg, vparams, _dtype(vis_cfg.compute_dtype))
              if kernels else None)

    @torch.no_grad()
    def run(patch_batches_u8, gen: torch.Generator) -> torch.Tensor:
        batches = torch.as_tensor(patch_batches_u8).to(dev)
        feats, valid = [], []
        for u8 in batches:
            # all-zero patches are padding: masked out of clustering
            valid.append((u8 != 0).flatten(1).any(1))
            feats.append(resnet.extract_from_uint8(rcfg, params, u8))
        feats, mask = torch.cat(feats), torch.cat(valid)
        _, labels, _, _ = km.kmeans_fit(feats, mask, gen, n_clusters=n_clusters,
                                        use_pallas=kernels)
        # fewer valid patches than clusters leaves NaN means: zero them
        cf = torch.nan_to_num(km.cluster_means(feats, labels, mask, n_clusters))
        if kernels:
            return cuda_vis.vis_apply_fused(vis_cfg, vparams, packed, cf[None])[0]
        return vis.apply(vis_cfg, vparams, cf[None])[0]

    return run
