"""One Lloyd accumulation pass of k-means: kernel K5 ``lloyd_stats``.

Counterpart of ``sequoia_tpu/ops/pallas_kmeans.py``.  Same contract: x (N, D)
f32, mask (N,) bool, centers (K, D) f32 -> (sums (K, D), counts (K,), inertia
(), best (N,)), masked rows contributing nothing and getting ``best = 0``.
Any N and any K are accepted (sentinel centers padded at 1e8, as the JAX
caller pads, never win); the kernel takes the centers in tiles of 128.

On CUDA tensors the kernel of ``csrc/lloyd_wgmma.cu`` runs (its source note
says what bounds it on the H100 and what its design does about it).  It
computes the distances from operands centered on the valid rows' mean mu,

    d2 = max(|x - mu|^2 + |c - mu|^2 - 2 (x - mu).(c - mu), 0),

with the product as three TF32 products on the tensor cores (3xTF32: each
operand split into a TF32 ``hi`` and the TF32 rounding of the rest, ``lo``;
hi.hi + hi.lo + lo.hi).  Distances do not change under translation, so this
is the JAX kernel's function; its rounding is that of sklearn's ``KMeans``,
which centers for the same reason: on features that lie close together far
from the origin, ``|x|^2 + |c|^2 - 2 x.c`` in f32 cancels most of its digits
and the argmin follows the rounding.  ``best``, each point's distance to its
center, is taken directly as ``|(x - mu) - (c - mu)|^2`` in f32: the tensor
cores accumulate by truncation, which would bias it.  x is fixed during a
fit, so :class:`LloydPlan` centers it once and every Lloyd step reuses it.

Plain versions: :func:`lloyd_stats_tc_plain` mirrors the kernel's recipe
(centering, TF32 rounding, the three products); :func:`lloyd_stats_plain` is
the JAX kernel's uncentered f32 recipe, which CPU tensors run (the parity
route against JAX).

The kmeans++ seeding of a fit, :func:`kmeans_seed`, is one more kernel
(``csrc/kmeans_seed.cu``, one launch a fit) with its plain mirror,
:func:`kmeans_seed_plain`: D^2 sampling as an exponential race keyed by
uniforms the caller draws, distances in f64.
"""

from __future__ import annotations

import torch

from sequoia_tpu_torch import _build


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero, as ``cvt.rna.tf32.f32``: half of the 13 dropped bits is added
    to the magnitude, then they are cleared.  Inf and NaN pass through."""
    bits = v.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(v), rounded, v)


def _reduce(x, mask, k, labels, best):
    """Labels (N,) among k centers and each point's best distance ->
    (sums, counts, inertia, best, labels); masked rows get best 0 and label
    -1 and contribute nothing."""
    maskf = mask.to(x.dtype)
    onehot = (labels[:, None] == torch.arange(k, device=x.device)).to(x.dtype)
    onehot = onehot * maskf[:, None]
    best = torch.where(mask, best, 0.0)
    return onehot.T @ x, onehot.sum(0), best.sum(), best, torch.where(mask, labels, -1)


def _reduce_d2(x, mask, d2):
    """_reduce of the first-index argmin of (N, K) distances and its d2."""
    labels = torch.argmin(d2, dim=1)  # first index on ties
    return _reduce(x, mask, d2.shape[1], labels, d2.gather(1, labels[:, None])[:, 0])


def _d2_plain(x, centers):
    """The JAX kernel's uncentered f32 distances (pallas_kmeans.py:56-58)."""
    x2 = (x * x).sum(1, keepdim=True)
    c2 = (centers * centers).sum(1)[None, :]
    return torch.clamp(x2 + c2 - 2.0 * (x @ centers.T), min=0.0)


def lloyd_stats_plain(x, mask, centers):
    """Plain PyTorch version of the JAX kernel's recipe: uncentered
    distances, first-index argmin, masked one-hot counts and sums."""
    return _reduce_d2(x, mask, _d2_plain(x, centers))[:4]


def lloyd_stats_tc_plain(x, mask, centers):
    """Plain PyTorch version of the kernel's recipe: mu over the valid rows,
    centered operands (masked rows zeroed), each split into TF32 hi and lo,
    d2 = max(|xc|^2 + |cc|^2 - 2 (xh.ch + xh.cl + xl.ch), 0), first-index
    argmin, and best = |xc - cc|^2 to the chosen center taken directly.
    Returns ``(sums, counts, inertia, best, labels)`` as
    :meth:`LloydPlan.stats` does (sums of the raw rows)."""
    n_valid = torch.clamp(mask.sum(), min=1)
    mu = torch.where(mask[:, None], x, 0.0).sum(0) / n_valid
    xc = torch.where(mask[:, None], x - mu, 0.0)
    cc = centers - mu
    x2 = (xc * xc).sum(1, keepdim=True)
    c2 = (cc * cc).sum(1)[None, :]
    xh, ch = tf32_round(xc), tf32_round(cc)
    xl, cl = tf32_round(xc - xh), tf32_round(cc - ch)
    dot = xh @ ch.T + xh @ cl.T + xl @ ch.T
    labels = torch.argmin(torch.clamp(x2 + c2 - 2.0 * dot, min=0.0), dim=1)
    return _reduce(x, mask, centers.shape[0], labels, ((xc - cc[labels]) ** 2).sum(1))


class LloydPlan:
    """K5 for one fit: x and mask are fixed across a fit's Lloyd steps, so
    on the card mu, x - mu and |x - mu|^2 are computed here once (two
    launches) and each :meth:`stats` call reuses them.  On CPU tensors
    :meth:`stats` runs :func:`lloyd_stats_plain`."""

    def __init__(self, x: torch.Tensor, mask: torch.Tensor):
        if x.ndim != 2 or x.dtype != torch.float32:
            raise TypeError(f"lloyd_stats: x must be (N, D) f32, got {x.dtype} {tuple(x.shape)}")
        n, d = x.shape
        if mask.shape != (n,):
            raise ValueError(f"lloyd_stats: x {tuple(x.shape)}, mask {tuple(mask.shape)}")
        if mask.device != x.device:
            raise ValueError("lloyd_stats: operands on different devices")
        self.x, self.mask = x, mask
        if not x.is_cuda:
            return
        if d % 4:
            raise ValueError(f"lloyd_stats kernel needs D % 4 == 0 (16-byte rows), got {d}")
        self.x = x.contiguous()
        if self.x.data_ptr() % 16:
            raise ValueError("lloyd_stats kernel needs x 16-byte aligned")
        self.mask = mask.to(torch.bool).contiguous()
        self.mu = torch.empty((d,), dtype=torch.float32, device=x.device)
        self.xc = torch.empty_like(self.x)
        self.x2 = torch.empty((n,), dtype=torch.float32, device=x.device)
        rc = _build.library().sq_lloyd_prepare(
            self.x.data_ptr(), self.mask.data_ptr(), n, d, self.mu.data_ptr(),
            self.xc.data_ptr(), self.x2.data_ptr(), _build.stream_ptr(x))
        _build.check(rc, "lloyd_stats (prepare)")
        _build.count_launch("lloyd_stats", 2)
        self._split = {}  # K -> (centers' hi, lo, |c - mu|^2): scratch of every step

    def stats(self, centers: torch.Tensor):
        """One Lloyd pass against ``centers`` (K, D): ``(sums (K, D), counts
        (K,), inertia (), best (N,), labels (N,))``, labels -1 on masked
        rows (int32 from the kernel)."""
        x = self.x
        n, d = x.shape
        k = centers.shape[0]
        if centers.dtype != torch.float32:
            raise TypeError("lloyd_stats: x and centers must be f32")
        if centers.ndim != 2 or centers.shape[1] != d:
            raise ValueError(f"lloyd_stats: x {tuple(x.shape)}, centers {tuple(centers.shape)}")
        if centers.device != x.device:
            raise ValueError("lloyd_stats: operands on different devices")
        if not x.is_cuda:
            return _reduce_d2(x, self.mask, _d2_plain(x, centers))
        if k < 1:
            raise ValueError("lloyd_stats kernel needs at least one center")
        centers = centers.contiguous()
        if centers.data_ptr() % 16:
            raise ValueError("lloyd_stats kernel needs centers 16-byte aligned")
        dev = x.device
        if k not in self._split:
            self._split[k] = (torch.empty((k, d), dtype=torch.float32, device=dev),
                              torch.empty((k, d), dtype=torch.float32, device=dev),
                              torch.empty((k,), dtype=torch.float32, device=dev))
        c_hi, c_lo, c2 = self._split[k]
        labels = torch.empty((n,), dtype=torch.int32, device=dev)
        best = torch.empty((n,), dtype=torch.float32, device=dev)
        sums = torch.empty((k, d), dtype=torch.float32, device=dev)
        counts = torch.empty((k,), dtype=torch.float32, device=dev)
        inertia = torch.empty((), dtype=torch.float32, device=dev)
        rc = _build.library().sq_lloyd_wgmma(
            x.data_ptr(), self.xc.data_ptr(), self.x2.data_ptr(), self.mask.data_ptr(),
            self.mu.data_ptr(), centers.data_ptr(), n, d, k, c_hi.data_ptr(),
            c_lo.data_ptr(), c2.data_ptr(), labels.data_ptr(), best.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), inertia.data_ptr(), _build.stream_ptr(x))
        _build.check(rc, "lloyd_stats")
        _build.count_launch("lloyd_stats", 3)
        return sums, counts, inertia, best, labels


def lloyd_stats(x: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor):
    """One fused Lloyd pass: ``(sums (K, D), counts (K,), inertia (), best (N,))``."""
    return LloydPlan(x, mask).stats(centers)[:4]


#: splitmix64's constants as int64: the golden-ratio step and the two mixers
_GOLDEN, _MIX1, _MIX2 = (c - (1 << 64) for c in (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9,
                                                  0x94D049BB133111EB))


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 (``>>`` on int64 is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def race_exp(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(k, n) f64: row r's Exp(1) draw for each pick, keyed by ``keys`` (k,)
    int64, the bits of the picks' uniforms: -log of ((z >> 11) + 1/2)
    2^-53, z splitmix64 of key + (r + 1) times the golden step (int64
    products wrap, as the kernel's unsigned ones do)."""
    z = keys[:, None] + torch.arange(1, n + 1, dtype=torch.int64, device=keys.device) * _GOLDEN
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    z = z ^ _shr(z, 31)
    return -torch.log((_shr(z, 11).double() + 0.5) * 2.0 ** -53)


def kmeans_seed_plain(x: torch.Tensor, mask: torch.Tensor, u: torch.Tensor):
    """kmeans++ (D^2 sampling, one draw a center) from the uniforms ``u``
    (k,) f64: ``(centers (k, D), indices (k,) int64)``.  The weights: for
    the first center the valid rows; for center i each row's least squared
    distance to the centers so far (summed in f64), zero on masked rows and
    on rows that hold a center already; where no weight is left, the valid
    rows again.  The pick is an exponential race keyed by ``u[i]``: the row
    with weight whose :func:`race_exp` draw over its weight is least (the
    first on a tie), row r with probability w_r / T.  Unlike an inverse CDF
    over the cumulative weights, a change in one row's weight moves the
    pick only where it changes the winner, so the features' rounding seldom
    changes the seeding.  No host sync.  The draws of all picks are made at
    once, and the differences to a center go into one f64 buffer kept
    across the picks."""
    n, k = x.shape[0], u.shape[0]
    x64 = x.double()
    diff = torch.empty_like(x64)
    valid = mask.to(torch.float64)
    exp = race_exp(u.contiguous().view(torch.int64), n)
    d2 = torch.full((n,), float("inf"), dtype=torch.float64, device=x.device)
    idx = torch.empty((k,), dtype=torch.int64, device=x.device)
    w = valid
    for i in range(k):
        if i:
            torch.sub(x64, x64.index_select(0, idx[i - 1:i]), out=diff)
            d2 = torch.minimum(d2, diff.square_().sum(1))
            w = torch.where(mask & (d2 > 0), d2, 0.0)
            w = torch.where(w.sum() > 0, w, valid)
        score = torch.where(w > 0, exp[i] / w, float("inf"))
        idx[i:i + 1] = torch.argmin(score, 0, keepdim=True)
    return x.index_select(0, idx), idx


def kmeans_seed(x: torch.Tensor, mask: torch.Tensor, u: torch.Tensor):
    """:func:`kmeans_seed_plain`'s function in one launch of
    ``csrc/kmeans_seed.cu``: CUDA tensors, x (N, D) f32 with D % 4 == 0,
    16-byte aligned."""
    if x.ndim != 2 or x.dtype != torch.float32:
        raise TypeError(f"kmeans_seed: x must be (N, D) f32, got {x.dtype} {tuple(x.shape)}")
    n, d = x.shape
    if mask.shape != (n,) or u.ndim != 1 or u.dtype != torch.float64:
        raise ValueError(f"kmeans_seed: x {tuple(x.shape)}, mask {tuple(mask.shape)}, "
                         f"u {u.dtype} {tuple(u.shape)}")
    if not (x.is_cuda and mask.device == x.device and u.device == x.device):
        raise ValueError(f"kmeans_seed kernel needs its operands on one CUDA device, got "
                         f"{x.device}, {mask.device}, {u.device}")
    k = u.shape[0]
    if n < 1 or k < 1:
        raise ValueError(f"kmeans_seed kernel needs a row and a center, got N={n}, k={k}")
    if d % 4:
        raise ValueError(f"kmeans_seed kernel needs D % 4 == 0 (16-byte rows), got {d}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("kmeans_seed kernel needs x 16-byte aligned")
    mask, u = mask.to(torch.bool).contiguous(), u.contiguous()
    centers = torch.empty((k, d), dtype=torch.float32, device=x.device)
    idx = torch.empty((k,), dtype=torch.int64, device=x.device)
    ws = torch.empty((8 * n,), dtype=torch.float64, device=x.device)
    rc = _build.library().sq_kmeans_seed(
        x.data_ptr(), mask.data_ptr(), u.data_ptr(), n, d, k, centers.data_ptr(),
        idx.data_ptr(), ws.data_ptr(), _build.stream_ptr(x))
    _build.check(rc, "kmeans_seed")
    _build.count_launch("kmeans_seed")
    return centers, idx
