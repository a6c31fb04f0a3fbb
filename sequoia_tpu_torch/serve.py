"""Slide serving, from patches to a gene panel: the aggregation tail of the
whole-slide inference path.

Counterpart of ``sequoia_tpu/serve.py:49-101, 362-406`` (``SlidePredictor``
for ``model_type="vis"``):

    predict_patches(u8)           features -> k-means -> ViS fold ensemble
    predict_features(feats)       k-means -> ViS fold ensemble
    predict_cluster_features(cf)  ViS fold ensemble only

The fold ensemble is the mean over folds of each fold's prediction (the
reference's 5-fold averaging).  Each fold runs the plain ``vis.apply``, or
with ``use_fused_vis`` its blocks run through the K1 kernel
(``ops/cuda_vis.vis_apply_fused``, B = 1 per slide; off by default, as JAX
serves through ``vis.apply``).  ``use_pallas_kmeans`` (the JAX
name) runs every Lloyd step through the K5 kernel.  Slides with fewer
patches than clusters get their empty clusters zero-filled.  WSI reading,
tissue screening and the streaming modes are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sequoia_tpu_torch.models import vis
from sequoia_tpu_torch.ops import cuda_vis
from sequoia_tpu_torch.ops import kmeans as km
from sequoia_tpu_torch.ops.nn import compute_dtype, precision
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.utils.device import resolve_device, tree_to


class SlidePredictor:
    def __init__(self, extractor: FeatureExtractor,
                 vis_models: list[tuple[vis.ViSConfig, dict]], *,
                 model_type: str = "vis", n_clusters: int = 100, kmeans_seed: int = 0,
                 use_pallas_kmeans: bool = False, use_fused_vis: bool = False,
                 device=None):
        if model_type != "vis":
            raise NotImplementedError(f"model_type {model_type!r} is not ported yet "
                                      "(ROADMAP.md)")
        self.device = resolve_device(device)
        if extractor is not None and extractor.device != self.device:
            raise ValueError(f"extractor runs on {extractor.device}, predictor on "
                             f"{self.device}")
        precision()
        self.extractor = extractor
        self.model_type = model_type
        self.n_clusters = n_clusters
        self.kmeans_seed = kmeans_seed
        self.use_pallas = use_pallas_kmeans
        self.vis_models = [(cfg, tree_to(params, self.device)) for cfg, params in vis_models]
        self._packed = None
        if use_fused_vis:
            for cfg, _ in self.vis_models:
                if not cuda_vis.supported(cfg):
                    raise ValueError(f"use_fused_vis: {cfg} does not fit the fused "
                                     "kernel's packed layout")
            self._packed = [cuda_vis.pack_vis_blocks(cfg, params,
                                                     compute_dtype(cfg.compute_dtype))
                            for cfg, params in self.vis_models]

    @torch.no_grad()
    def cluster(self, feats) -> torch.Tensor:
        """(N, D) patch features -> (n_clusters, D) cluster means on the device."""
        if feats.shape[0] == 0:
            raise ValueError("no tissue patches survived screening")
        x = torch.as_tensor(feats).to(self.device).float()
        mask = torch.ones((x.shape[0],), dtype=torch.bool, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.kmeans_seed)
        _, labels, _, _ = km.kmeans_fit(x, mask, gen, n_clusters=self.n_clusters,
                                        use_pallas=self.use_pallas)
        cf = km.cluster_means(x, labels, mask, self.n_clusters)
        if x.shape[0] < self.n_clusters:
            # small slide: some clusters are necessarily empty (NaN means);
            # zero-pad them as the reference's <100-token windows
            print(f"serve: {x.shape[0]} patches < n_clusters={self.n_clusters}; "
                  f"empty clusters zero-padded", file=sys.stderr)
            cf = torch.nan_to_num(cf)
        return cf

    @torch.no_grad()
    def predict_cluster_features(self, cf) -> np.ndarray:
        """(N, D) or (B, N, D) cluster features -> fold-averaged (B, G)."""
        cf = torch.as_tensor(cf).to(self.device).float()
        if cf.ndim == 2:
            cf = cf[None]
        preds = []
        for i, (cfg, params) in enumerate(self.vis_models):
            if self._packed is None:
                preds.append(vis.apply(cfg, params, cf))
            else:
                preds.append(torch.cat([
                    cuda_vis.vis_apply_fused(cfg, params, self._packed[i], cf[b:b + 1])
                    for b in range(cf.shape[0])]))
        return torch.stack(preds).mean(0).cpu().numpy()

    def predict_features(self, feats) -> np.ndarray:
        return self.predict_cluster_features(self.cluster(feats))

    def predict_patches(self, patches_u8) -> np.ndarray:
        return self.predict_features(self.extractor.features(patches_u8))
