"""Canonical typed configuration.

Counterpart of ``sequoia_tpu/config.py`` (a copy: the port imports nothing
of the JAX package), with one addition: ``feature_dims`` also names the
Virchow2 backbone, which the JAX package does not have.  The reference
hard-codes its architecture and training constants at call sites across six
scripts (SURVEY.md section 5 config/flag system).  This module is the
documented source of those values; no module of either package imports it,
and the port's CLIs default to the same values (``tests/test_torch_config.py``
holds both).

Values and their reference provenance:
* ViS/ViT: depth 6, 16 heads, f/s/c dims 64, dim_head 64, mlp 2048,
  100 cluster tokens (reference main.py model ctors, pretrain_gtex.py).
* HE2RNA: layers (256, 256), ks (1,2,5,10,20,50,100), dropout 0.5
  (reference he2rna.py __main__).
* Training: AdamW lr 1e-3 wd 0, batch 16, 5 folds, patience 20, delta 0.5,
  save_on/stop_on 'loss'|'loss+corr' (reference main.py / scripts);
  GTEx pretraining lr 3e-3 (pretrain_gtex.py); HE2RNA Adam patience 100.
* Pipeline: patch size 256 at 20x, tissue thresholds 0.2 (tiling) / 0.5
  (visualization), 3 morphology iterations, candidate-shuffle seed 5,
  max 4000 patches/slide, 100 k-means clusters, KMeans random_state 0.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AggregatorDefaults:
    depth: int = 6
    num_heads: int = 16
    dim_f: int = 64
    dim_s: int = 64
    dim_c: int = 64
    dim_head: int = 64
    mlp_dim: int = 2048
    num_clusters: int = 100


@dataclasses.dataclass(frozen=True)
class HE2RNADefaults:
    layers: tuple[int, ...] = (256, 256)
    ks: tuple[int, ...] = (1, 2, 5, 10, 20, 50, 100)
    dropout: float = 0.5
    patience: int = 100


@dataclasses.dataclass(frozen=True)
class TrainDefaults:
    lr: float = 1e-3
    pretrain_lr: float = 3e-3
    weight_decay: float = 0.0
    batch_size: int = 16
    num_epochs: int = 200
    k_folds: int = 5
    patience: int = 20
    delta: float = 0.5
    valid_size: float = 0.1
    split_random_state: int = 0
    seed: int = 99


@dataclasses.dataclass(frozen=True)
class PipelineDefaults:
    patch_size: int = 256
    reference_magnification: float = 20.0
    tiling_tissue_threshold: float = 0.2
    visualization_tissue_threshold: float = 0.5
    morphology_iterations: int = 3
    candidate_shuffle_seed: int = 5
    max_patches_per_slide: int = 4000
    num_clusters: int = 100
    kmeans_random_state: int = 0
    feature_dims: tuple[tuple[str, int], ...] = (("resnet", 2048), ("uni", 1024),
                                                 ("virchow2", 2560))
    sliding_window: int = 10
    sliding_window_min_tiles: int = 50
    sliding_stride: int = 1


AGGREGATOR = AggregatorDefaults()
HE2RNA = HE2RNADefaults()
TRAIN = TrainDefaults()
PIPELINE = PipelineDefaults()
