"""Per-slide k-means: kmeans++ seeding + Lloyd iterations on the device.

Counterpart of ``sequoia_tpu/ops/kmeans.py``.  Same algorithm as the
reference's ``sklearn.cluster.KMeans(n_clusters=100, random_state=0)``:
kmeans++ seeding, Lloyd with sklearn's relative tolerance
``tol * mean(var(X))``, empty clusters relocated to the farthest points, and
a final donor repair so no cluster ends empty when there are enough points.
Padded rows (``mask`` False) never win an assignment and never contribute.

Differences of form from the JAX module:

* the ``while_loop`` is a Python loop with one host sync per iteration;
* ``jax.lax.top_k`` (index order on ties) is a stable descending sort;
* the final donor repair runs on the host in numpy, and only when the final
  assignment left a cluster empty (otherwise it changes nothing);
* the RNG is a ``torch.Generator``: kmeans++ draws its k uniforms at once
  and picks each center by an exponential race on the D^2 mass keyed by
  one of them (JAX's ``categorical`` draws from the same distribution with
  another stream), so :func:`kmeans_fit` agrees with JAX in inertia, and
  :func:`kmeans_lloyd` from shared centers agrees exactly.

``use_pallas=True`` (the JAX flag name) runs the fit through the kernels:
the seeding in one ``kmeans_seed`` launch, then one
``ops/cuda_kmeans.LloydPlan`` (K5) per fit, whose stats give every step and
the final assignment.  On the card its distances are taken from operands
centered on the mean (``ops/cuda_kmeans.py`` says why), so on near-tie
features its steps follow a float64 fit, where the JAX recipe's may not.
"""

from __future__ import annotations

import numpy as np
import torch

from sequoia_tpu_torch.ops import cuda_kmeans
from sequoia_tpu_torch.utils.device import resolve_device
from sequoia_tpu_torch.utils.profiling import BINCOUNT_SYNCS, count, span


def _pairwise_sq_dist(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N, D), (k, D) -> (N, k) squared distances (f32)."""
    xx = (x * x).sum(1, keepdim=True)
    cc = (centers * centers).sum(1)
    return torch.clamp(xx + cc - 2.0 * (x @ centers.T), min=0.0)


def _plusplus_init(gen: torch.Generator, x: torch.Tensor, mask: torch.Tensor,
                   k: int, use_pallas: bool = False) -> torch.Tensor:
    """kmeans++ (D^2 sampling) over the valid rows: one ``torch.rand(k)``
    of f64 uniforms from ``gen``, then the picks by an exponential race a
    uniform keys (``cuda_kmeans.kmeans_seed_plain``; ``use_pallas`` on CUDA
    tensors: the ``kmeans_seed`` kernel, one launch).  Both backends take
    the same uniforms, so they draw the same centers up to the f64 rounding
    of the distances' sums."""
    u = torch.rand(k, generator=gen, dtype=torch.float64, device=x.device)
    kernel = use_pallas and x.is_cuda
    return (cuda_kmeans.kmeans_seed if kernel else cuda_kmeans.kmeans_seed_plain)(x, mask, u)[0]


def _assign(x, mask, centers):
    d2 = _pairwise_sq_dist(x, centers)
    labels = torch.argmin(d2, dim=1)  # first index on ties
    best = d2.gather(1, labels[:, None])[:, 0]
    return labels, torch.where(mask, best, 0.0)


def _stats_fn(x, mask, use_pallas: bool):
    """centers -> (sums (k, D), counts (k,), best (N,), labels (N,)) of the
    assignment to ``centers``: through one K5 plan for the fit, or the plain
    distance GEMM."""
    if use_pallas:
        plan = cuda_kmeans.LloydPlan(x, mask)

        def stats(centers):
            sums, counts, _, best, labels = plan.stats(centers)
            return sums, counts, best, labels.long()
        return stats

    def stats(centers):
        labels, best = _assign(x, mask, centers)
        onehot = (labels[:, None] == torch.arange(centers.shape[0], device=x.device)).to(x.dtype)
        onehot = onehot * mask.to(x.dtype)[:, None]
        return onehot.T @ x, onehot.sum(0), best, labels
    return stats


def _donor_repair(x, mask, labels, centers, best):
    """Fill each cluster the final assignment left empty with the farthest
    valid point of a donor cluster (>= 2 members), one round per cluster in
    cluster order (sklearn ``_relocate_empty_clusters`` semantics)."""
    k = centers.shape[0]
    counts = torch.bincount(labels[mask], minlength=k)
    # the masked select sizes its output on the host, then the bincount, the bool
    count("host_syncs", 1 + BINCOUNT_SYNCS + 1)
    if not bool((counts == 0).any()):
        return labels, centers, best
    lab = labels.cpu().numpy().copy()
    bst = best.cpu().numpy().copy()
    msk = mask.cpu().numpy()
    cnt = counts.cpu().numpy().copy()
    moves = []
    for c in range(k):
        if cnt[c] != 0:
            continue
        score = np.where(msk & (cnt[lab] >= 2), bst, -np.inf)
        p = int(np.argmax(score))
        if not np.isfinite(score[p]):
            continue
        cnt[lab[p]] -= 1
        cnt[c] += 1
        lab[p] = c
        bst[p] = 0.0  # the point becomes its cluster's center
        moves.append((c, p))
    centers = centers.clone()
    for c, p in moves:
        centers[c] = x[p]
    dev = x.device
    count("host_syncs", 4 + 2)  # the four reads above, the two blocking uploads below
    return (torch.as_tensor(lab, device=dev), centers, torch.as_tensor(bst, device=dev))


def _lloyd_step(x, centers, stats, tol_abs, min_empty: int):
    """One Lloyd step: the new centers, and a (2,) bool tensor saying whether
    the shift and whether an unexpected empty cluster keep the loop alive."""
    kk = min(centers.shape[0], x.shape[0])
    sums, counts, best, _ = stats(centers)
    new_centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1.0), centers)
    # empty clusters move to the farthest valid points (masked rows have
    # best = 0 and sort last; ties keep index order)
    empty = counts == 0
    far = torch.sort(best, descending=True, stable=True).indices[:kk]
    pos = torch.cumsum(empty.to(torch.int64), 0) - 1
    candidates = x[far[torch.clamp(pos, 0, kk - 1)]]
    new_centers = torch.where(empty[:, None], candidates, new_centers)
    shift = ((new_centers - centers) ** 2).sum()
    return new_centers, torch.stack((shift > tol_abs, empty.sum() > min_empty))


def _lloyd(x, mask, centers, max_iter: int, tol_abs, use_pallas: bool = False,
           trace: list | None = None):
    """Lloyd steps until the shift is within ``tol_abs`` and no unexpected
    cluster is empty, then the final assignment and donor repair.  ``trace``
    (a list) receives each step's (shift alive, empty alive) pair.  Spans
    ``kmeans.lloyd`` (the steps, with the plan they share) and
    ``kmeans.means`` (the final assignment and the repair); counts
    ``kmeans.lloyd_steps``."""
    with span("kmeans.lloyd"):
        # with fewer valid points than clusters, k - n_valid clusters can
        # never fill: only unexpected empties keep the loop alive
        min_empty = max(0, centers.shape[0] - int(mask.sum()))
        count("host_syncs")  # the valid count's readback
        stats = _stats_fn(x, mask, use_pallas)
        n_iter = 0
        while n_iter < max_iter:
            centers, alive = _lloyd_step(x, centers, stats, tol_abs, min_empty)
            n_iter += 1
            by_shift, by_empty = alive.tolist()  # one host sync per step
            count("kmeans.lloyd_steps")
            count("host_syncs")
            if trace is not None:
                trace.append((by_shift, by_empty))
            if not (by_shift or by_empty):
                break
    with span("kmeans.means"):
        # the final assignment by the distances the loop converged on
        _, _, best, labels = stats(centers)
        labels, centers, best = _donor_repair(x, mask, labels, centers, best)
    return centers, labels, best.sum(), n_iter


def _tol_abs(x, mask, tol: float):
    """sklearn's relative tolerance over the valid rows: tol * mean(var)."""
    maskf = mask.to(x.dtype)[:, None]
    n_valid = torch.clamp(maskf.sum(), min=1.0)
    mean = (x * maskf).sum(0) / n_valid
    var = (((x - mean) * maskf) ** 2).sum(0) / n_valid
    return tol * var.mean()


def kmeans_fit(x: torch.Tensor, mask: torch.Tensor, gen: torch.Generator,
               n_clusters: int = 100, max_iter: int = 300, tol: float = 1e-4,
               use_pallas: bool = False):
    """One slide: x (N, D), mask (N,) bool, ``gen`` on x's device.  Returns
    (centers (k, D), labels (N,) -- arbitrary on masked rows, inertia,
    n_iter).  The seeding is the span ``kmeans.seed``."""
    x = x.float()
    with span("kmeans.seed"):
        centers = _plusplus_init(gen, x, mask, n_clusters, use_pallas)
    return _lloyd(x, mask, centers, max_iter, _tol_abs(x, mask, tol), use_pallas)


def kmeans_lloyd(x: torch.Tensor, mask: torch.Tensor, init_centers: torch.Tensor,
                 max_iter: int = 300, tol: float = 1e-4, use_pallas: bool = False):
    """Lloyd iterations from explicit initial centers; same return contract
    as :func:`kmeans_fit`."""
    x = x.float()
    return _lloyd(x, mask, init_centers.float(), max_iter, _tol_abs(x, mask, tol),
                  use_pallas)


def cluster_means(x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                  n_clusters: int = 100) -> torch.Tensor:
    """Mean raw feature per final label (the reference's cluster_features);
    NaN for an empty cluster, as ``np.mean`` over an empty slice."""
    onehot = (labels[:, None] == torch.arange(n_clusters, device=x.device)).to(x.dtype)
    onehot = onehot * mask.to(x.dtype)[:, None]
    counts = onehot.sum(0)[:, None]
    sums = onehot.T @ x
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                       torch.full_like(sums, float("nan")))


def kmeans_cluster_features(features: np.ndarray, n_clusters: int = 100, seed: int = 0,
                            backend: str = "device", device=None,
                            use_pallas: bool = False) -> np.ndarray:
    """(N, D) patch features -> (k, D) cluster-mean features.

    backend='device': this module's kmeans++/Lloyd.  backend='hybrid':
    sklearn-exact kmeans++ seeding on the host, then Lloyd on the device.
    ``use_pallas`` runs those Lloyd steps through K5.  backend='sklearn':
    the reference's own ``KMeans(random_state=seed)`` on the host, NaN for
    an empty cluster as the per-label ``np.mean`` gives; it needs sklearn
    (the GPU machine has none) and raises an ImportError without it."""
    features = np.asarray(features, np.float32)
    if backend == "sklearn":
        try:
            from sklearn.cluster import KMeans
        except ImportError as e:
            raise ImportError("kmeans backend 'sklearn' needs scikit-learn, which does "
                              "not import here; use backend 'hybrid' (its seeding) or "
                              "'device'") from e
        labels = KMeans(n_clusters=n_clusters, random_state=seed).fit(features).labels_
        means = [np.mean(features[labels == pos], axis=0) if np.any(labels == pos)
                 else np.full(features.shape[1], np.nan, np.float32)
                 for pos in range(n_clusters)]
        return np.asarray(means, dtype=np.float32)
    if backend not in ("device", "hybrid"):
        # a misspelt backend must not write cluster_features that the
        # skip-if-present rule then keeps
        raise ValueError(f"backend must be 'device', 'hybrid' or 'sklearn'; got {backend!r}")
    dev = resolve_device(device)
    x = torch.as_tensor(features, device=dev)
    mask = torch.ones((features.shape[0],), dtype=torch.bool, device=dev)
    if backend == "hybrid":
        init = torch.as_tensor(sklearn_plusplus_centers(features, n_clusters, seed), device=dev)
        _, labels, _, _ = kmeans_lloyd(x, mask, init, use_pallas=use_pallas)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        _, labels, _, _ = kmeans_fit(x, mask, gen, n_clusters=n_clusters,
                                     use_pallas=use_pallas)
    return cluster_means(x, labels, mask, n_clusters).cpu().numpy()


# ---------------------------------------------------------------------------
# host seeding with sklearn's exact stream (numpy copies of the JAX module's)
# ---------------------------------------------------------------------------

def _sklearn_sq_dists(A: np.ndarray, B: np.ndarray,
                      b_norms: np.ndarray | None = None) -> np.ndarray:
    """Squared euclidean distances with sklearn's float semantics (float32
    inputs: one float64 pass, downcast, clip at 0)."""
    if A.dtype == np.float32 or B.dtype == np.float32:
        A64 = A.astype(np.float64)
        B64 = B.astype(np.float64)
        d = -2.0 * (A64 @ B64.T)
        d += (A64 * A64).sum(axis=1)[:, None]
        d += (B64 * B64).sum(axis=1)[None, :]
        d = d.astype(np.float32)
    else:
        d = -2.0 * (A @ B.T)
        d += (A * A).sum(axis=1)[:, None]
        d += (b_norms if b_norms is not None else (B * B).sum(axis=1))[None, :]
    np.maximum(d, 0.0, out=d)
    return d


def plusplus_indices(X: np.ndarray, n_clusters: int,
                     random_state: np.random.RandomState) -> np.ndarray:
    """Greedy kmeans++ drawing sklearn's RandomState stream and float
    arithmetic: n_local_trials = 2 + int(log(k)), first center by
    ``random_state.choice``, candidates by ``uniform * current_pot``
    searchsorted into the cumulative D^2 mass, greedy potential minimum."""
    n_samples = X.shape[0]
    n_local_trials = 2 + int(np.log(n_clusters))
    weights = np.ones(n_samples, X.dtype) / n_samples

    indices = np.full(n_clusters, -1, dtype=int)
    indices[0] = random_state.choice(n_samples, p=weights)
    closest = _sklearn_sq_dists(X[indices[0]][None], X)[0]
    sample_weight = np.ones(n_samples, X.dtype)
    current_pot = closest @ sample_weight

    for c in range(1, n_clusters):
        rand_vals = random_state.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(np.cumsum(sample_weight * closest), rand_vals)
        np.clip(candidate_ids, None, closest.size - 1, out=candidate_ids)

        dist = _sklearn_sq_dists(X[candidate_ids], X)
        np.minimum(closest, dist, out=dist)
        pots = dist @ sample_weight.reshape(-1, 1)

        best = int(np.argmin(pots))
        current_pot = pots[best]
        closest = dist[best]
        indices[c] = candidate_ids[best]
    return indices


def sklearn_plusplus_centers(features: np.ndarray, n_clusters: int,
                             seed: int = 0) -> np.ndarray:
    """kmeans++ seeding identical to ``KMeans(random_state=seed)``'s,
    including its mean-centering before seeding; returns the original rows."""
    X = np.ascontiguousarray(features, np.float32)
    Xc = X - X.mean(axis=0)
    rs = seed if isinstance(seed, np.random.RandomState) else np.random.RandomState(seed)
    return X[plusplus_indices(Xc, n_clusters, rs)].astype(np.float32)
