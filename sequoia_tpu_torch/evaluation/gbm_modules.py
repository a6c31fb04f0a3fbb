"""GBM meta-module (Neftel-style) co-expression analysis.

Counterpart of ``sequoia_tpu/evaluation/gbm_modules.py`` (a copy: the port
imports nothing of the JAX package).  Host code: pandas, matplotlib and
seaborn are imported inside the functions that use them.

Behavior contract (reference ``spatial_vis/gbm_celltype_analysis.py``):
given per-tile gene prediction maps (``stride-1.csv``) and meta-module gene
lists (AC / G1S / G2M / MES1 / MES2 / NPC1 / NPC2 / OPC), produce
(1) per-slide gene-gene Spearman/Pearson correlation matrices ordered by
module for clustermap plotting, and (2) per-tile module assignment = the
module whose member-gene percentile scores have the highest mean, for
spatial scatter maps.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.stats import rankdata

DEFAULT_MODULES = ("AC", "G1S", "G2M", "MES1", "MES2", "NPC1", "NPC2", "OPC")


def load_modules(module_dir: str, modules=DEFAULT_MODULES) -> dict[str, list[str]]:
    """{module: [genes]} from ``{module_dir}/{name}.npy`` gene-name arrays."""
    out = {}
    for m in modules:
        path = os.path.join(module_dir, f"{m}.npy")
        if os.path.exists(path):
            out[m] = [str(g) for g in np.load(path, allow_pickle=True)]
    return out


def module_gene_columns(pred_df: pd.DataFrame,
                        modules: dict[str, list[str]]) -> dict[str, list[str]]:
    """Module genes actually present as prediction columns."""
    return {m: [g for g in genes if g in pred_df.columns]
            for m, genes in modules.items()}


def correlation_matrix(pred_df: pd.DataFrame, modules: dict[str, list[str]],
                       method: str = "pearson") -> pd.DataFrame:
    """Gene-gene correlation over tiles, genes ordered by module."""
    cols = [g for genes in module_gene_columns(pred_df, modules).values()
            for g in genes]
    # reference listwise deletion (gbm_celltype_analysis.py:72 dropna before
    # .corr()): pandas pairwise deletion would silently change every value
    # when NaN tiles exist (routine border tiles in stride-1.csv)
    return pred_df[cols].dropna(axis=0, how="any").corr(method=method)


MERGED_CATEGORIES = {
    "ac": ("AC",),
    "cc": ("G1S", "G2M"),
    "mes": ("MES1", "MES2"),
    "lin": ("NPC1", "NPC2", "OPC"),
}


def merge_categories(modules: dict[str, list[str]],
                     categories: dict[str, tuple] = None) -> dict[str, list[str]]:
    """The reference's merged coloring categories (ac / cc=cell-cycle /
    mes / lin=lineage) from the eight Neftel modules."""
    categories = categories or MERGED_CATEGORIES
    return {label: [g for m in parts for g in modules.get(m, [])]
            for label, parts in categories.items()}


def percentile_scores(pred_df: pd.DataFrame,
                      modules: dict[str, list[str]]) -> pd.DataFrame:
    """Per-tile per-module score: mean expression over the module's genes,
    percentile-transformed within the slide (the reference's order of
    operations: mean first, then ``percentileofscore``)."""
    import pandas as pd

    present = module_gene_columns(pred_df, modules)
    all_genes = [g for genes in present.values() for g in genes]
    # reference listwise dropna FIRST (gbm_celltype_analysis.py:97): a
    # single NaN tile would otherwise poison percentileofscore (scipy>=1.9
    # NaN propagation) into an all-NaN module column
    clean = pred_df[all_genes].dropna(axis=0, how="any")
    out = pd.DataFrame(index=pred_df.index)  # dropped tiles stay NaN
    for m, genes in present.items():
        if not genes:
            continue
        vals = clean[genes].mean(axis=1).to_numpy()
        if len(vals):
            # rankdata == percentileofscore kind='rank' per element (to
            # float rounding), O(n log n) instead of O(n^2) over the slide
            out.loc[clean.index, m] = (rankdata(vals, method="average")
                                       / len(vals) * 100.0)
        else:
            out[m] = np.nan
    return out


def assign_modules(pred_df: pd.DataFrame,
                   modules: dict[str, list[str]]) -> pd.Series:
    """Per-tile argmax module/category (the reference's spatial coloring
    rule: highest percentile of the category mean).  NaN-dropped tiles get
    NaN assignments."""
    import pandas as pd

    scores = percentile_scores(pred_df, modules)
    valid = scores.dropna(how="all")
    out = pd.Series(np.nan, index=scores.index, dtype=object)
    if len(valid):
        out.loc[valid.index] = valid.idxmax(axis=1)
    return out


def average_correlation(corr_dfs: list[pd.DataFrame]) -> pd.DataFrame:
    """Across-slide mean gene-gene correlation (the reference's
    ``total_clustered`` map)."""
    out = corr_dfs[0].copy()
    for df in corr_dfs[1:]:
        out = out + df
    return out / len(corr_dfs)


def plot_clustermap(corr: pd.DataFrame, save_to: str | None = None):
    import matplotlib

    matplotlib.use("Agg")
    import seaborn as sns

    g = sns.clustermap(corr.fillna(0), cmap="vlag", vmin=-1, vmax=1)
    if save_to:
        g.savefig(save_to, dpi=150)
    return g


def plot_spatial_modules(pred_df: pd.DataFrame, assignments: pd.Series,
                         save_to: str | None = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    for m in sorted(assignments.dropna().unique()):
        sel = assignments == m
        ax.scatter(pred_df.loc[sel, "xcoord_tf"], pred_df.loc[sel, "ycoord_tf"],
                   s=8, label=m)
    ax.invert_yaxis()
    ax.legend(markerscale=2, fontsize=8)
    ax.set_aspect("equal")
    if save_to:
        fig.savefig(save_to, dpi=150)
    plt.close(fig)
    return fig
