"""HE2RNA training (``fit``) with the reference's selection rules.

Counterpart of ``sequoia_tpu/train/he2rna_fit.py`` (reference
``src/he2rna.py:108-320``; ``fit`` at ``:217-320``):

* Adam (not AdamW), ``weight_decay=0``; MSE loss (``loop.make_adam``);
* the train-mode forward draws one k per step and applies Dropout(0.5);
* validation each epoch: the loss of the raw predictions and the mean
  per-gene Pearson r of ReLU(predictions) over the whole split; the best
  model has the highest correlation, patience 100;
* an evaluation before training seeds ``best`` (NaN read as 0); where no
  epoch improved on it, the final model is saved and used;
* prediction applies the ReLU (reference ``he2rna_predict``).

The step runs eagerly on the device.  Each step's loss stays a 0-d device
tensor, read once per epoch.  The dropout masks come from a generator on the
device and the k of each step from a CPU generator, both seeded with
``seed``; their draws differ from the JAX package's PRNG by nature, so runs
agree with JAX's only where neither draws (dropout 0, one k).
"""

from __future__ import annotations

import numpy as np
import torch

from sequoia_tpu_torch.data.dataset import BatchLoader, prefetch
from sequoia_tpu_torch.models import he2rna
from sequoia_tpu_torch.ops import stats
from sequoia_tpu_torch.train.loop import _batch_to, _host, _uploader, make_adam, tree_map
from sequoia_tpu_torch.utils.device import resolve_device, tree_to


def make_he2rna_eval_step(cfg: he2rna.HE2RNAConfig):
    """``eval_step(params, feats, rna, valid) -> (relu_pred, metrics)``: the
    eval forward, the loss of the raw predictions and the mean correlation
    of their ReLU, as 0-d device tensors."""

    @torch.no_grad()
    def eval_step(params, feats, rna, valid):
        pred = he2rna.apply(cfg, params, feats)
        relu_pred = torch.relu(pred)
        return relu_pred, {"loss": stats.masked_mse(pred, rna, valid),
                           "corr": stats.mean_correlation(relu_pred, rna, valid)}

    return eval_step


def make_he2rna_step_fns(cfg: he2rna.HE2RNAConfig, optimizer: torch.optim.Optimizer, *,
                         gen: torch.Generator | None = None,
                         k_gen: torch.Generator | None = None):
    """(train_step, eval_step).  ``train_step(params, feats, rna, valid) ->
    loss``: the train-mode forward (k from ``k_gen``, dropout from ``gen``),
    the masked MSE's backward and one step of ``optimizer``, which must hold
    the leaves of ``params``; the loss is the forward's, a 0-d device tensor."""

    def train_step(params, feats, rna, valid):
        optimizer.zero_grad(set_to_none=True)
        pred = he2rna.apply(cfg, params, feats, train=True, gen=gen, k_gen=k_gen)
        loss = stats.masked_mse(pred, rna, valid)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step, make_he2rna_eval_step(cfg)


def he2rna_evaluate(cfg, params, loader: BatchLoader, eval_step=None, *, device=None):
    """``(valid_loss, mean_corr)``, the reference ``he2rna.evaluate`` epoch
    metrics: the mean of the batches' losses, and the correlation over the
    whole split's ReLU predictions on the host (NaN for an empty loader)."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    eval_step = eval_step or make_he2rna_eval_step(cfg)
    losses, preds, labels = [], [], []
    for batch in loader:
        if batch.n_valid == 0:
            continue
        p, m = eval_step(params, *_batch_to(batch, dev))
        losses.append(m["loss"])
        preds.append(p.float().cpu().numpy()[batch.valid])
        labels.append(batch.rna[batch.valid])
    if not losses:
        return np.nan, np.nan
    score = host_compute_correlations(np.concatenate(labels), np.concatenate(preds))
    return float(torch.stack(losses).mean().cpu()), score


def host_compute_correlations(labels: np.ndarray, preds: np.ndarray) -> float:
    """Reference ``compute_correlations`` on the host over a whole split:
    the mean Pearson r of the genes whose labels are not constant, NaNs
    (constant predictions) dropped.  Every gene at once in float64, as
    ``np.corrcoef`` computes each (clipped to [-1, 1]); the JAX package's
    per-gene loop takes about a second an evaluation at 20,820 genes."""
    y = np.asarray(labels, np.float64)
    p = np.asarray(preds, np.float64)
    varies = (y != y[:1]).any(axis=0)
    yc = y[:, varies] - y[:, varies].mean(0)
    pc = p[:, varies] - p[:, varies].mean(0)
    with np.errstate(invalid="ignore", divide="ignore"):
        rs = np.clip((yc * pc).sum(0) / np.sqrt((yc * yc).sum(0) * (pc * pc).sum(0)), -1, 1)
    rs = rs[~np.isnan(rs)]
    return float(np.mean(rs)) if rs.size else np.nan


def he2rna_predict(cfg, params, loader: BatchLoader, eval_step=None, *, device=None):
    """``(relu_preds, labels, wsis, projs)`` over the loader's valid rows,
    the reference ``he2rna_predict``; an empty loader gives empty arrays."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    eval_step = eval_step or make_he2rna_eval_step(cfg)
    preds, labels, wsis, projs = [], [], [], []
    for batch in loader:
        if batch.n_valid == 0:
            continue
        p, _ = eval_step(params, *_batch_to(batch, dev))
        preds.append(p.float().cpu().numpy()[batch.valid])
        labels.append(batch.rna[batch.valid])
        wsis.extend(w for w, v in zip(batch.wsi, batch.valid) if v)
        projs.extend(p_ for p_, v in zip(batch.project, batch.valid) if v)
    if not preds:
        g = getattr(loader.ds, "num_genes", 0)
        return (np.zeros((0, g), np.float32), np.zeros((0, g), np.float32),
                np.asarray([], str), np.asarray([], str))
    return (np.concatenate(preds), np.concatenate(labels), np.asarray(wsis),
            np.asarray(projs))


def fit(cfg, params, lr, train_loader, valid_loader, test_loader, *,
        max_epochs: int = 200, patience: int = 100, seed: int = 0, save_fn=None,
        log_fn=None, verbose: bool = True, prefetch_depth: int = 2, device=None):
    """The reference ``he2rna.fit`` on ``device`` (cuda unless asked
    otherwise; raises without CUDA).  Trains a device copy of ``params``.
    ``save_fn(params)`` gets a host copy wherever the reference saves the
    model.  Returns ``(preds, labels, wsis, projs)`` of the best params on
    ``test_loader`` when one is given, else the best params (on the CPU)."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.detach().to(dev, copy=True).requires_grad_(True), params)
    optimizer = make_adam(params, lr)
    train_step, eval_step = make_he2rna_step_fns(
        cfg, optimizer, gen=torch.Generator(device=dev).manual_seed(seed),
        k_gen=torch.Generator().manual_seed(seed))

    if valid_loader is not None:
        _, best = he2rna_evaluate(cfg, params, valid_loader, eval_step, device=dev)
        if np.isnan(best):
            best = 0.0
        if verbose:
            print(f"correlations: {best:.3f}")
    else:
        best = 0.0

    best_params = tree_map(_host, params)
    saved_any = False
    epoch_since_best = 0
    to_device = _uploader(dev, None)
    for e in range(max_epochs):
        epoch_since_best += 1
        tlosses = []
        batches = (prefetch(train_loader, depth=prefetch_depth, transform=to_device)
                   if prefetch_depth else map(to_device, train_loader))
        try:
            for item in batches:
                if item is not None:
                    tlosses.append(train_step(params, *item))
        finally:
            if prefetch_depth:
                batches.close()
        # one host read of the epoch's losses
        train_loss = float(torch.stack(tlosses).mean().cpu()) if tlosses else np.nan

        if valid_loader is not None:
            valid_loss, score = he2rna_evaluate(cfg, params, valid_loader, eval_step,
                                                device=dev)
            if log_fn:
                log_fn(e, "val", {"loss": valid_loss, "corr": score, "train_loss": train_loss})
            if verbose:
                print(f"Epoch {e + 1}/{max_epochs} loss: {train_loss:.4f}, "
                      f"val loss: {valid_loss:.4f}, correlations: {score:.3f}")
            if score > best:
                epoch_since_best = 0
                best = score
                best_params = tree_map(_host, params)
                saved_any = True
                if save_fn is not None:
                    save_fn(best_params)
            if epoch_since_best == patience:
                if verbose:
                    print(f"Early stopping at epoch {e + 1}")
                break
        elif verbose:
            print(f"Epoch {e + 1}/{max_epochs} loss: {train_loss:.4f}")

    if not saved_any:
        # reference fit(): no epoch improved on the first score, so the
        # final model is saved and used
        best_params = tree_map(_host, params)
        if save_fn is not None:
            save_fn(best_params)

    if test_loader is not None:
        return he2rna_predict(cfg, best_params, test_loader, eval_step, device=dev)
    return best_params
