"""Training and evaluation metrics on the device, masked for padded batches.

Counterpart of ``sequoia_tpu/ops/stats.py``.  Reference semantics:

* ``mean_correlation`` (reference ``compute_correlations``): per-gene Pearson
  r over the batch's valid rows, genes with constant targets skipped, NaN r
  dropped, the mean over the rest; NaN when every gene is skipped (the
  reference's ``np.mean`` of an empty list).
* ``masked_smape``: ``100/B * sum(2|F-A| / (|A|+|F|))``, where the sum runs
  over ALL elements but is divided by the row count only (kept as the
  reference has it); 0/0 elements count 0.
* MSE and MAE are plain means over the valid rows.

Every function computes in f32 on the batch's device and returns a 0-d
tensor (``pearson_per_gene`` a ``(G,)`` one), so the training loop can keep
the metrics on the device until an epoch phase ends.
"""

from __future__ import annotations

import torch


def _prep(pred, target, valid):
    """(pred, target) in f32, the (B, 1) row mask and the valid-row count
    (at least 1)."""
    pred, target = pred.float(), target.float()
    m = valid[:, None].to(torch.float32)
    n = valid.sum().clamp(min=1).to(torch.float32)
    return pred, target, m, n


def masked_mse(pred, target, valid):
    pred, target, m, n = _prep(pred, target, valid)
    return ((pred - target).square() * m).sum() / (n * target.shape[1])


def masked_mae(pred, target, valid):
    pred, target, m, n = _prep(pred, target, valid)
    return ((pred - target).abs() * m).sum() / (n * target.shape[1])


def masked_smape(pred, target, valid):
    pred, target, m, n = _prep(pred, target, valid)
    num = 2.0 * (pred - target).abs()
    den = target.abs() + pred.abs()
    pos = den > 0
    ratio = torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                        torch.zeros_like(den))
    return 100.0 / n * (ratio * m).sum()


def pearson_per_gene(pred, target, valid):
    """(G,) per-gene Pearson r over the valid rows; NaN where undefined."""
    pred, target, m, n = _prep(pred, target, valid)
    dp = (pred - (pred * m).sum(0) / n) * m
    dt = (target - (target * m).sum(0) / n) * m
    cov = (dp * dt).sum(0)
    return cov / torch.sqrt((dp * dp).sum(0) * (dt * dt).sum(0))


def mean_correlation(pred, target, valid):
    """Mean per-gene Pearson r, skipping constant-target genes and NaN r;
    NaN when every gene is skipped."""
    _, t, m, n = _prep(pred, target, valid)
    dt = (t - (t * m).sum(0) / n) * m
    r = pearson_per_gene(pred, target, valid)
    ok = ((dt * dt).sum(0) > 0) & ~torch.isnan(r)
    count = ok.sum()
    mean_r = torch.where(ok, r, torch.zeros_like(r)).sum() / count.clamp(min=1)
    return torch.where(count > 0, mean_r, torch.full_like(mean_r, float("nan")))
