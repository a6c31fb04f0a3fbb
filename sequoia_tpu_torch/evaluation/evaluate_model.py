"""Offline per-gene evaluation of ``test_results.pkl``.

Counterpart of ``sequoia_tpu/evaluation/evaluate_model.py`` (reference
``evaluation/evaluate_model.py:29-143``), vectorized over genes.  Per cancer
the k folds' test predictions are concatenated; per gene: Pearson(real,
pred) and Pearson(real, random), the one-tailed Steiger test of "model r >
random r", RMSE variants, and Benjamini-Hochberg FDR over the Pearson and
Steiger p's.  A gene is significant iff ``r_pred > 0 & pearson_p < .05 &
rmse_pred < rmse_random & r_pred > r_random & steiger_p < .05 &
fdr_steiger < 0.2``.  A gene whose real, predicted or random column is
constant gets r = 0 and p = 1 (reference ``evaluate_model.py:72-74``).

Outputs: ``all_genes.csv``, ``sig_genes.csv`` and ``num_sign_genes.csv``
with the reference's columns.  BH is computed here, equal to statsmodels'
``fdrcorrection(method='indep')``.  pandas is imported inside the functions
that build tables.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
from scipy import stats as sstats

from sequoia_tpu_torch.evaluation.correlation_stats import dependent_corr

DEFAULT_CANCERS = ("brca", "coad", "gbm", "kirp", "kirc", "luad", "lusc", "paad", "prad",
                   "skcm", "thca", "ucec", "hnsc", "stad", "blca", "lihc")


def fdr_bh(pvals: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg adjusted p-values."""
    p = np.asarray(pvals, dtype=np.float64)
    n = p.size
    order = np.argsort(p)
    ranked = p[order] * n / np.arange(1, n + 1)
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    ranked = np.clip(ranked, 0, 1)
    out = np.empty(n)
    out[order] = ranked
    return out


def pearson_with_p(x: np.ndarray, y: np.ndarray):
    """Columnwise Pearson r and two-sided p (the t approximation of
    ``scipy.stats.pearsonr``) for (n, G) matrices -> ((G,), (G,))."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = x.shape[0]
    xc = x - x.mean(axis=0)
    yc = y - y.mean(axis=0)
    sx = np.sqrt((xc**2).sum(axis=0))
    sy = np.sqrt((yc**2).sum(axis=0))
    with np.errstate(invalid="ignore", divide="ignore"):
        r = (xc * yc).sum(axis=0) / (sx * sy)
        r = np.clip(r, -1.0, 1.0)
        tstat = r * np.sqrt((n - 2) / np.maximum(1e-300, 1 - r**2))
        p = 2 * sstats.t.sf(np.abs(tstat), n - 2)
    return r, p


def evaluate_split_results(test_res: dict, folds: int | None = None):
    """Per-gene stats table (a DataFrame indexed by gene, sorted by
    ``pred_real_r`` descending) for one cancer's ``test_results.pkl`` dict;
    ``folds`` None counts its ``split_*`` keys."""
    import pandas as pd

    genes = list(test_res["genes"])
    if folds is None:
        folds = sum(1 for k in test_res if str(k).startswith("split_"))
    real = np.concatenate([np.asarray(test_res[f"split_{k}"]["real"]) for k in range(folds)])
    pred = np.concatenate([np.asarray(test_res[f"split_{k}"]["preds"]) for k in range(folds)])
    rand = np.concatenate([np.asarray(test_res[f"split_{k}"]["random"])
                           for k in range(folds)])
    n = real.shape[0]

    const = ((real == real[0]).all(axis=0) | (pred == pred[0]).all(axis=0)
             | (rand == rand[0]).all(axis=0))
    xy, p1 = pearson_with_p(real, pred)
    xz, _ = pearson_with_p(real, rand)
    yz, _ = pearson_with_p(pred, rand)
    _, steiger_p = dependent_corr(xy, xz, yz, n, twotailed=False, conf_level=0.95,
                                  method="steiger")
    xy = np.where(const, 0.0, xy)
    xz = np.where(const, 0.0, xz)
    p1 = np.where(const, 1.0, p1)
    steiger_p = np.where(const, 1.0, steiger_p)

    rmse_pred = np.sqrt(np.mean((real - pred) ** 2, axis=0))
    rmse_random = np.sqrt(np.mean((real - rand) ** 2, axis=0))
    iqr = np.quantile(real, 0.75, axis=0) - np.quantile(real, 0.25, axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        rmse_q = rmse_pred / (iqr + 1e-5)
        rmse_m = rmse_pred / np.mean(real, axis=0)

    res = pd.DataFrame({"pred_real_r": xy, "random_real_r": xz, "pearson_p": p1,
                        "Steiger_p": steiger_p, "rmse_pred": rmse_pred,
                        "rmse_random": rmse_random, "rmse_quantile_norm": rmse_q,
                        "rmse_mean_norm": rmse_m}, index=genes)
    res = res.sort_values("pred_real_r", ascending=False)
    res["pred_real_r"] = res["pred_real_r"].fillna(0)
    res["random_real_r"] = res["random_real_r"].fillna(0)
    res["pearson_p"] = res["pearson_p"].fillna(1)
    res["fdr_pearson_p"] = fdr_bh(res["pearson_p"].to_numpy())
    res["Steiger_p"] = res["Steiger_p"].fillna(1)
    res["fdr_Steiger_p"] = fdr_bh(res["Steiger_p"].to_numpy())
    return res


def significant_genes(all_res):
    """The reference's significance gate (``evaluate_model.py:131-136``)."""
    return all_res[(all_res["pred_real_r"] > 0)
                   & (all_res["pearson_p"] < 0.05)
                   & (all_res["rmse_pred"] < all_res["rmse_random"])
                   & (all_res["pred_real_r"] > all_res["random_real_r"])
                   & (all_res["Steiger_p"] < 0.05)
                   & (all_res["fdr_Steiger_p"] < 0.2)]


def evaluate_model_dir(model_dir: str, cancers=DEFAULT_CANCERS, folds: int | None = None,
                       save_path: str | None = None):
    """The reference's flow: each ``{model_dir}/{cancer}/test_results.pkl``
    -> the combined all / significant / count CSVs under ``save_path``
    (default ``{model_dir}/results``).  A cancer whose file is missing or
    unreadable is reported and skipped; none readable raises.  Returns
    ``(all_res, sig_res)``."""
    import pandas as pd

    save_path = save_path or os.path.join(model_dir, "results")
    os.makedirs(save_path, exist_ok=True)
    df_list = []
    for cancer in cancers:
        pkl = os.path.join(model_dir, cancer, "test_results.pkl")
        if not os.path.exists(pkl):
            print(f"no data for {cancer}")
            continue
        try:
            with open(pkl, "rb") as f:
                test_res = pickle.load(f)
            res = evaluate_split_results(test_res, folds=folds)
        except Exception as e:  # noqa: BLE001 — per-cancer quarantine (reference)
            print(f"no data for {cancer} ({type(e).__name__}: {e})")
            continue
        res["cancer"] = cancer
        df_list.append(res)
    if not df_list:
        raise FileNotFoundError(f"no readable test_results.pkl under {model_dir} for any of "
                                f"{list(cancers)}")
    all_res = pd.concat(df_list)
    sig_res = significant_genes(all_res)
    all_res.to_csv(os.path.join(save_path, "all_genes.csv"))
    sig_res.to_csv(os.path.join(save_path, "sig_genes.csv"))
    num_sig = sig_res["cancer"].value_counts().reset_index()
    num_sig.columns = ["cancer", "num_genes"]
    num_sig.to_csv(os.path.join(save_path, "num_sign_genes.csv"))
    return all_res, sig_res
