"""k-means as the reference runs it (scikit-learn's ``KMeans``: kmeans++
seeding, Lloyd steps until the centres move less than ``tol`` times the mean
feature variance, the means of the final assignment), and the judge's
reading of a program's cluster means."""

from __future__ import annotations

import torch

from benchmark.reference import numerics as nx


def _sq_dist(x, c, mode):
    return ((x * x).sum(1, keepdim=True) + (c * c).sum(1)[None]
            - 2.0 * nx.matmul(x, c.T, mode)).clamp(min=0)


def fit_means(x: torch.Tensor, k: int, gen: torch.Generator, mode: str = "float32",
              max_iter: int = 300, tol: float = 1e-4) -> torch.Tensor:
    """(N, D) -> (k, D) cluster means, every distance product in ``mode``."""
    with nx.precision(mode):
        x = x.float()
        n = x.shape[0]
        centers = x[torch.randint(n, (1,), generator=gen, device=x.device)]
        d2 = _sq_dist(x, centers, mode)[:, 0]
        for _ in range(1, min(k, n)):
            w = d2 if float(d2.sum()) > 0 else torch.ones_like(d2)
            nxt = x[torch.multinomial(w, 1, generator=gen)]
            centers = torch.cat([centers, nxt])
            d2 = torch.minimum(d2, _sq_dist(x, nxt, mode)[:, 0])
        tol_abs = tol * x.var(0, unbiased=False).mean()
        labels = None
        for _ in range(max_iter):
            labels = _sq_dist(x, centers, mode).argmin(1)
            new = means(x, labels, centers.shape[0], fill=centers)
            shift = ((new - centers) ** 2).sum()
            centers = new
            if shift <= tol_abs:
                break
        labels = _sq_dist(x, centers, mode).argmin(1)
        return torch.nan_to_num(means(x, labels, k))


def means(x: torch.Tensor, labels: torch.Tensor, k: int, fill=None) -> torch.Tensor:
    """Mean of the rows of each label; an empty label keeps ``fill``'s row
    (NaN without one)."""
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    sums.index_add_(0, labels, x)
    counts = torch.bincount(labels, minlength=k).to(x.dtype)[:, None]
    out = sums / counts.clamp(min=1)
    empty = counts == 0
    other = fill if fill is not None else torch.full_like(out, float("nan"))
    return torch.where(empty, other, out)


def partition_means(x: torch.Tensor, cf: torch.Tensor):
    """The partition of the rows of ``x`` (N, D) that the centres ``cf``
    (k, D) define, each row to its nearest centre in float64: ``(means (k,
    D) f64, NaN for a cluster no row is nearest to; labels; counts)``."""
    x64, c64 = x.double(), cf.double()
    d2 = ((x64 * x64).sum(1, keepdim=True) + (c64 * c64).sum(1)[None]
          - 2.0 * x64 @ c64.T)
    labels = d2.argmin(1)
    k = c64.shape[0]
    return means(x64, labels, k), labels, torch.bincount(labels, minlength=k).double()


def misfit(x: torch.Tensor, cf: torch.Tensor) -> float:
    """The share of the rows of ``x`` (N, D) that the cluster means ``cf``
    (k, D) do not account for.  The rows of each cluster of
    :func:`partition_means` are averaged to M.  Where cf holds the means of
    exactly that partition, M equals cf to rounding; each row that sits in
    another cluster than the one whose mean took it moves that mean by
    about its distance to the centre over the cluster's size.  So
    ``sum_c n_c^2 |M_c - cf_c|^2 / (N s^2)``, with ``s^2`` the mean squared
    distance of a row to its nearest centre, counts such rows (each twice:
    where it left and where it went) as a share of N.  A converged k-means
    reads rounding and the few rows that its last step moved across a
    border; distances taken too coarsely to find the nearest centre, or
    means over the wrong rows, read more.  A row of ``cf`` that no row is
    nearest to counts as a cluster's worth of rows unless it is zero (the
    program fills an empty cluster with zeros); a ``cf`` that is not finite
    reads infinity."""
    if not bool(torch.isfinite(cf).all()):
        return float("inf")
    m, labels, counts = partition_means(x, cf)
    x64, c64 = x.double(), cf.double()
    n, k = x64.shape[0], c64.shape[0]
    s2 = float((x64 - c64[labels]).square().sum(1).mean().clamp(min=1e-300))
    full = counts > 0
    moved = float((counts[full] ** 2 * (m[full] - c64[full]).square().sum(1)).sum()) / (n * s2)
    lost = int(((~full) & (c64.abs().amax(1) != 0)).sum())
    return moved + lost / k
