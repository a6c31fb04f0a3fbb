"""Spatial-map vs ground-truth metrics: Earth Mover's Distance and helpers.

Counterpart of ``sequoia_tpu/evaluation/spatial_metrics.py`` (a copy: the
port imports nothing of the JAX package).  Host code: pandas, ``cv2``
(``calculate_emd``) and scanpy (``load_ground_truth_adata``) are imported
inside the functions that use them.

Behavior contract (reference ``spatial_vis/get_emd.py:27-90,142-205``): per gene, the
prediction map (``stride-1.csv``) is compared with spatial-transcriptomics
ground truth: nearest-``num_tiles`` GT spots are averaged onto each
prediction tile, a 3x3 median filter + percentile transform smooth the GT,
and 2-D EMD with L2 ground distance (``cv2.EMD``) scores the pair.  Both
maps are shifted non-negative and normalized to unit mass; all-zero maps
give EMD 0 (both) or NaN (one).

scanpy is optional here: ``load_ground_truth_h5ad`` uses it when installed;
otherwise pass a ``(x, y, gene_expr)`` DataFrame straight to
``attach_ground_truth``.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import percentileofscore


def score2percentile(score: float, ref: np.ndarray) -> float:
    if np.isnan(score):
        return score
    return percentileofscore(ref, score)


def get_average(xcoord, ycoord, gt_df: pd.DataFrame, num_tiles: int = 4) -> float:
    """Mean of the ``num_tiles`` nearest ground-truth spots."""
    d = np.sqrt((gt_df["x"] - xcoord) ** 2 + (gt_df["y"] - ycoord) ** 2).to_numpy()
    closest = np.argsort(d, kind="stable")[:num_tiles]
    return float(gt_df["gene_expr"].to_numpy()[closest].mean())


def median_filter(df: pd.DataFrame, col: str, xcoord: int, ycoord: int,
                  num_neighbors: int = 1) -> float:
    window = df[(df["xcoord_tf"] >= xcoord - num_neighbors)
                & (df["ycoord_tf"] >= ycoord - num_neighbors)
                & (df["xcoord_tf"] <= xcoord + num_neighbors)
                & (df["ycoord_tf"] <= ycoord + num_neighbors)]
    full = (num_neighbors * 2 + 1) ** 2
    if window.shape[0] > full / 2:
        return float(np.median(window[col].values))
    return float(df[(df["xcoord_tf"] == xcoord)
                    & (df["ycoord_tf"] == ycoord)][col].values[0])


def img_to_sig(arr: np.ndarray) -> np.ndarray:
    """2-D array -> cv2.EMD signature rows (weight, i, j)."""
    h, w = arr.shape
    ii, jj = np.mgrid[0:h, 0:w]
    return np.stack([arr.ravel(), ii.ravel(), jj.ravel()],
                    axis=1).astype(np.float32)


def calculate_emd(arr1: np.ndarray, arr2: np.ndarray, norm: bool = False) -> float:
    import cv2

    assert arr1.shape == arr2.shape, f"shape mismatch {arr1.shape} vs {arr2.shape}"
    assert arr1.ndim == 2, f"expected a 2-D map, got ndim={arr1.ndim}"
    if (not np.any(arr1)) and (not np.any(arr2)):
        return 0.0
    if not np.any(arr1) or not np.any(arr2):
        return float("nan")
    a1 = arr1 / np.sum(arr1)
    a2 = arr2 / np.sum(arr2)
    dist, _, _ = cv2.EMD(img_to_sig(a1), img_to_sig(a2), cv2.DIST_L2)
    if norm:
        dist = dist / np.sqrt(arr1.shape[0] * arr2.shape[0])
    return float(dist)


def grid_from_df(df: pd.DataFrame, col: str) -> np.ndarray:
    """Scatter a tile column onto the dense (max_x+1, max_y+1) grid and shift
    non-negative (reference fill_arr + abs-min shift)."""
    max_x = int(df["xcoord_tf"].max())
    max_y = int(df["ycoord_tf"].max())
    arr = np.zeros((max_x + 1, max_y + 1))
    for _, row in df.iterrows():
        arr[int(row["xcoord_tf"]), int(row["ycoord_tf"])] = row[col]
    return arr + np.abs(np.min(arr))


def attach_ground_truth(pred_df: pd.DataFrame, gt_df: pd.DataFrame,
                        num_tiles: int = 4) -> pd.DataFrame:
    """Add ``ground_truth`` (+ filtered/percentile variants) columns to a
    prediction-map DataFrame."""
    df2 = pred_df.dropna(axis=0, how="any").copy()
    df2["ground_truth"] = df2.apply(
        lambda r: get_average(r["xcoord"], r["ycoord"], gt_df, num_tiles), axis=1)
    df2 = df2.dropna(axis=0, how="any")
    df2["ground_truth_filt"] = df2.apply(
        lambda r: median_filter(df2, "ground_truth", r["xcoord_tf"],
                                r["ycoord_tf"], 1), axis=1)
    ref = df2["ground_truth_filt"].values
    df2["ground_truth_filt"] = df2.apply(
        lambda r: score2percentile(r["ground_truth_filt"], ref), axis=1)
    return df2


def emd_for_gene(pred_df: pd.DataFrame, gt_df: pd.DataFrame, gene: str,
                 num_tiles: int = 4) -> dict[str, float]:
    """Raw + percentile/median-filtered EMD for one gene (reference per-gene
    loop body)."""
    df2 = attach_ground_truth(pred_df, gt_df, num_tiles)
    ref2 = df2[gene].values
    df2[gene + "_filt"] = df2.apply(
        lambda r: score2percentile(r[gene], ref2), axis=1)

    out = {}
    for suffix, gt_col, gene_col in (("", "ground_truth", gene),
                                     ("_filt", "ground_truth_filt", gene + "_filt")):
        arr0 = grid_from_df(df2, gene_col)
        arr1 = grid_from_df(df2, gt_col)
        out["emd" + suffix] = calculate_emd(arr0, arr1, norm=False)
        out["nr_gt_vals" + suffix] = len(np.unique(df2[gt_col].values))
    return out


def load_ground_truth_adata(path: str):
    """Visium h5ad -> preprocessed AnnData (scanpy normalize+log1p+scale,
    the reference preprocessing).  Gene-independent: load ONCE, then slice
    per gene with :func:`ground_truth_gene_df` — re-running this per gene
    re-scales the whole matrix hundreds of times."""
    import scanpy as sc

    adata = sc.read_h5ad(path)
    sc.pp.normalize_total(adata, inplace=True)
    sc.pp.log1p(adata)
    sc.pp.scale(adata)
    return adata


def ground_truth_gene_df(adata, gene: str) -> pd.DataFrame:
    """(x, y, gene_expr) slice of a preprocessed AnnData for one gene."""
    import pandas as pd

    sub = adata[:, gene]
    df = pd.DataFrame(sub.obs[["x", "y"]].values, columns=["x", "y"])
    df["gene_expr"] = np.asarray(sub.X).flatten()
    return df


def load_ground_truth_h5ad(path: str, gene: str) -> pd.DataFrame:
    """One-shot convenience: load + preprocess + slice one gene (for many
    genes use load_ground_truth_adata once + ground_truth_gene_df)."""
    return ground_truth_gene_df(load_ground_truth_adata(path), gene)
