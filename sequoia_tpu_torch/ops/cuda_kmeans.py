"""One Lloyd accumulation pass of k-means: kernel K5 ``lloyd_stats``.

Counterpart of ``sequoia_tpu/ops/pallas_kmeans.py``.  Same contract: x (N, D)
f32, mask (N,) bool, centers (K, D) f32 (the caller pads k with 1e8 sentinel
centers, which never win) -> (sums (K, D), counts (K,), inertia (), best
(N,)), masked rows contributing nothing and getting ``best = 0``.  Any N is
accepted.

On CUDA tensors the kernel of ``csrc/lloyd_stats.cu`` runs (it says what
bounds it on the H100 and what its design does about it); on CPU tensors
:func:`lloyd_stats_plain` does.
"""

from __future__ import annotations

import torch

from sequoia_tpu_torch import _build


def lloyd_stats_plain(x, mask, centers):
    """Plain PyTorch version: distances, first-index argmin, masked one-hot
    counts and sums."""
    x2 = (x * x).sum(1, keepdim=True)
    c2 = (centers * centers).sum(1)[None, :]
    d2 = torch.clamp(x2 + c2 - 2.0 * (x @ centers.T), min=0.0)
    labels = torch.argmin(d2, dim=1)  # first index on ties
    best = d2.gather(1, labels[:, None])[:, 0]
    maskf = mask.to(x.dtype)
    onehot = (labels[:, None] == torch.arange(centers.shape[0], device=x.device)).to(x.dtype)
    onehot = onehot * maskf[:, None]
    best = best * maskf
    return onehot.T @ x, onehot.sum(0), best.sum(), best


def lloyd_stats(x: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor):
    """One fused Lloyd pass: ``(sums (K, D), counts (K,), inertia (), best (N,))``."""
    n, d = x.shape
    k = centers.shape[0]
    if x.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("lloyd_stats: x and centers must be f32")
    if centers.shape[1] != d or mask.shape != (n,):
        raise ValueError(f"lloyd_stats: x {tuple(x.shape)}, mask {tuple(mask.shape)}, "
                         f"centers {tuple(centers.shape)}")
    if mask.device != x.device or centers.device != x.device:
        raise ValueError("lloyd_stats: operands on different devices")
    if not x.is_cuda:
        return lloyd_stats_plain(x, mask, centers)
    if k > 128:
        raise ValueError(f"lloyd_stats kernel takes at most 128 centers, got {k}")
    x = x.contiguous()
    centers = centers.contiguous()
    mask_u8 = mask.to(torch.bool).contiguous()
    c2 = (centers * centers).sum(1)
    dev = x.device
    labels = torch.empty((n,), dtype=torch.int32, device=dev)
    best = torch.empty((n,), dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    inertia = torch.empty((), dtype=torch.float32, device=dev)
    rc = _build.library().sq_lloyd_stats(
        x.data_ptr(), mask_u8.data_ptr(), centers.data_ptr(), c2.data_ptr(), n, d, k,
        labels.data_ptr(), best.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        inertia.data_ptr(), _build.stream_ptr(x))
    _build.check(rc, "lloyd_stats")
    _build.count_launch("lloyd_stats", 2)
    return sums, counts, inertia, best
