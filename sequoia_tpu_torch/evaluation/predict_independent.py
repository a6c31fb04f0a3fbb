"""Independent-cohort inference with 5-fold ViS weights.

Counterpart of ``sequoia_tpu/evaluation/predict_independent.py`` (reference
``evaluation/predict_independent_dataset.py:44-96``, its shipped bugs fixed):
loads the fold checkpoints, predicts the cohort with every fold, averages the
folds, and pairs the result with a fold-averaged untrained-model baseline
drawn from a ``torch.Generator`` seeded with ``seed`` (its draws differ from
the JAX package's PRNG by nature).  Output: ``test_results.pkl`` =
``{'pred': DataFrame, 'random': DataFrame}`` indexed by slide, one column a
gene.

A fold source is a local ``.pt`` file or a local hub-layout directory (a
``{fold}`` template such as ``folds/model_best_{fold}.pt``); a hub repo
prefix (``gevaertlab/sequoia-brca``) raises: the port downloads nothing.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from sequoia_tpu_torch.data import dataset as ds
from sequoia_tpu_torch.models import convert, vis
from sequoia_tpu_torch.ops.nn import precision
from sequoia_tpu_torch.train import checkpoint
from sequoia_tpu_torch.utils.device import resolve_device, tree_to


def fold_checkpoint_source(template: str, fold: int) -> str:
    """``template`` with ``{fold}`` filled in (a local layout), or a hub
    prefix such as ``gevaertlab/sequoia-brca`` with ``-{fold}`` appended."""
    if "{fold}" in template:
        return template.format(fold=fold)
    return f"{template}-{fold}"


@torch.no_grad()
def ensemble_predict(cfg, fold_params_list, loader, *, device=None):
    """The fold-averaged predictions of the loader's valid rows: each fold's
    ``vis.apply`` on the batch, averaged over the folds.  Returns
    ``(mean_preds (n, G), wsis)``."""
    dev = resolve_device(device)
    precision()
    folds = [tree_to(p, dev) for p in fold_params_list]
    preds, wsis = [], []
    for batch in loader:
        if batch.n_valid == 0:
            continue
        x = torch.from_numpy(batch.features).to(dev)
        p = torch.stack([vis.apply(cfg, fp, x) for fp in folds]).mean(0)  # (B, G)
        preds.append(p.float().cpu().numpy()[batch.valid])
        wsis.extend(w for w, v in zip(batch.wsi, batch.valid) if v)
    return (np.concatenate(preds) if preds else np.zeros((0, cfg.num_outputs), np.float32),
            np.asarray(wsis))


def _load_fold(src: str) -> dict:
    if os.path.isfile(src):
        return checkpoint.load_torch_checkpoint(src)
    if os.path.isdir(src):
        return checkpoint.load_hf_vis_state_dict(src)
    raise FileNotFoundError(
        f"fold checkpoint {src!r} is neither a local .pt file nor a local hub-layout "
        "directory; the port downloads nothing: give --checkpoint_template a local "
        "'{fold}' path (e.g. snapshots/sequoia-brca-{fold})")


def predict_independent(df, feature_path: str, save_dir: str, *, checkpoint_template: str,
                        folds: int = 5, feature_use: str = "cluster_features",
                        batch_size: int = 16, depth: int = 6, num_heads: int = 16,
                        seed: int = 99, verbose: bool = True, device=None) -> dict:
    """Predict the cohort of ``df`` with the ``folds`` checkpoints of
    ``checkpoint_template`` on ``device`` (cuda unless asked otherwise) and
    write ``{save_dir}/test_results.pkl``.  The random null is ``folds``
    fresh ViS models of the loaded folds' architecture (their token count
    included) and this cohort's gene count."""
    import pandas as pd

    dev = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    genes = ds.gene_names(df)

    test_ds = ds.FeatureDataset(df, feature_path, feature_use=feature_use)
    loader = ds.BatchLoader(test_ds, batch_size, shuffle=False)

    cfg, fold_params = None, []
    for fold in range(folds):
        src = fold_checkpoint_source(checkpoint_template, fold)
        fcfg, params = convert.vis_from_torch(_load_fold(src))
        if cfg is None:
            cfg = fcfg
        elif fcfg != cfg:
            raise ValueError(f"fold {fold} architecture differs: {fcfg} != {cfg}")
        fold_params.append(params)
        if verbose:
            print(f"fold {fold}: loaded {src}")

    # the significance null has the ensemble's architecture (reference
    # predict_independent_dataset.py:75-80), its token count included
    rand_cfg = vis.ViSConfig(num_outputs=test_ds.num_genes, input_dim=test_ds.feature_dim,
                             depth=depth, nheads=num_heads, dim_f=64, dim_s=64, dim_c=64,
                             num_clusters=cfg.num_clusters)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand_params = [vis.init(rand_cfg, gen) for _ in range(folds)]

    avg_preds, wsis = ensemble_predict(cfg, fold_params, loader, device=dev)
    avg_random, _ = ensemble_predict(rand_cfg, rand_params, loader, device=dev)
    test_results = {
        "pred": pd.DataFrame(avg_preds, index=wsis, columns=genes),
        "random": pd.DataFrame(avg_random, index=wsis, columns=genes),
    }
    with open(os.path.join(save_dir, "test_results.pkl"), "wb") as f:
        pickle.dump(test_results, f, protocol=pickle.HIGHEST_PROTOCOL)
    return test_results
