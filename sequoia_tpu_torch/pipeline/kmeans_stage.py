"""Stage 3, k-means aggregation: patch features -> 100 cluster features.

Counterpart of ``sequoia_tpu/pipeline/kmeans_stage.py`` (reference
``pre_processing/kmean_features.py:65-113``): each slide's feature ``.h5``
gains a ``cluster_features`` (num_clusters, D) dataset, the mean raw feature
per final k-means label, appended in ``r+`` mode.  A slide is skipped when
its file has no ``feat_name`` dataset, fewer patches than clusters, or a
``cluster_features`` dataset already (which is never overwritten).

The reference resolves every slide's project from row 0 of the ref file
(``kmean_features.py:70``), a recorded bug; here, as in the JAX package,
each row's own ``tcga_project`` is used.  In GTEx mode (``gtex_tissue``)
the tissue names the directory and ``.svs`` is not stripped from the slide
name, as in the reference.

Every backend fits each slide on its own through
``ops/kmeans.kmeans_cluster_features`` and writes it as soon as it is fitted
(``use_pallas`` runs the Lloyd steps through K5).  The JAX package pads the
``tpu`` backend's slides to shape buckets and fits a group of them in one
vmapped program; that serves its compiler and has no counterpart here.
h5py is imported inside the functions that use it.
"""

from __future__ import annotations

import os

import numpy as np

from sequoia_tpu_torch.ops import kmeans as km
from sequoia_tpu_torch.utils.device import resolve_device


def _write_cluster_features(path: str, means: np.ndarray) -> bool:
    import h5py

    try:
        with h5py.File(path, "r+") as f:
            if "cluster_features" in f:
                return False
            f.create_dataset("cluster_features", data=means)
        return True
    except OSError as e:
        print(f"Error writing cluster_features to {path}: {e}")
        return False


def run_kmeans(df, feature_path: str, *, num_clusters: int = 100,
               feat_name: str = "resnet_features", seed: int = 0, backend: str = "device",
               gtex_tissue: str | None = None, use_pallas: bool = False,
               verbose: bool = True, device=None) -> int:
    """Append ``cluster_features`` for every slide of the ref-file DataFrame
    (duplicate ``wsi_file_name`` rows dropped), on ``device`` (CUDA unless
    given).  ``use_pallas`` runs the Lloyd steps through K5.  Returns the
    number of slides clustered."""
    import h5py

    if backend not in ("device", "hybrid", "sklearn"):
        raise ValueError(f"backend must be 'device', 'hybrid' or 'sklearn'; got {backend!r}")
    dev = None if backend == "sklearn" else resolve_device(device)
    df = df.drop_duplicates(["wsi_file_name"])
    done = 0
    for _, row in df.iterrows():
        wsi = str(row["wsi_file_name"])
        if gtex_tissue is not None:
            project = gtex_tissue
        else:
            project = row.get("tcga_project", "")
            wsi = wsi.replace(".svs", "")

        path = os.path.join(feature_path, str(project), wsi, wsi + ".h5")
        try:
            with h5py.File(path, "r") as f:
                if feat_name not in f:
                    if verbose:
                        print(f"No {feat_name} for {path}")
                    continue
                if f[feat_name].shape[0] < num_clusters:
                    if verbose:
                        print(f"{wsi} less number of patches than clusters")
                    continue
                if "cluster_features" in f:
                    if verbose:
                        print(f"{wsi}: Cluster feature already available")
                    continue
                features = np.asarray(f[feat_name][:], np.float32)
        except OSError:
            print(f"Cannot open file {path}")
            continue

        means = km.kmeans_cluster_features(features, num_clusters, seed, backend,
                                           device=dev, use_pallas=use_pallas)
        done += int(_write_cluster_features(path, means))
    return done
