"""Tissue masking on the device: HSV saturation, Otsu, morphology, contrast.

Counterpart of ``sequoia_tpu/ops/masking.py:28-202``.  The tissue mask is
(reference ``pre_processing/patch_gen_hdf5.py:25-38, 70-71, 110-115``)

    S > otsu(S)  AND  NOT (R > otsu(R) AND G > otsu(G) AND B > otsu(B))
    AND R > 50 AND G > 50 AND B > 50

with skimage semantics, then ``binary_dilation``/``erosion`` with scipy's
default cross and a zero border.  A patch is kept when its dilated tissue
mask covers more than ``background_threshold`` of it and it is not low
contrast (gray p99 - p1 below 5% of the [-1, 1] float range).

Every function takes leading batch axes, so a batch of candidate patches is
screened in one pass on the device.  The JAX histogram (one-hot counts
under ``lax.scan``) becomes ``bincount`` over per-row offsets: exact integer
counts.  The two Otsu paths of skimage are kept: uint8 values get one bin
per integer, floats 256 even bins over [min, max].  Argmax takes the first
index and percentiles interpolate linearly, as in JAX.
"""

from __future__ import annotations

import torch

from sequoia_tpu_torch.utils.profiling import BINCOUNT_SYNCS, count

_GRAY = (0.2125, 0.7154, 0.0721)  # skimage rgb2gray weights


def _unit(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> [0, 1] f32; floats as f32."""
    x = img.float()
    return x / 255.0 if img.dtype == torch.uint8 else x


def rgb_to_saturation(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8/float RGB -> HSV saturation (skimage: (max-min)/max,
    0 where max == 0)."""
    x = _unit(img)
    mx, mn = x.amax(-1), x.amin(-1)
    return torch.where(mx > 0, (mx - mn) / torch.where(mx > 0, mx, torch.ones_like(mx)),
                       torch.zeros_like(mx))


def _histogram(idx: torch.Tensor, nbins: int) -> torch.Tensor:
    """(..., P) bin indices in [0, nbins) -> (..., nbins) f32 counts (exact
    integers)."""
    lead = idx.shape[:-1]
    rows = idx.reshape(-1, idx.shape[-1]).long()
    offs = torch.arange(rows.shape[0], device=idx.device)[:, None] * nbins
    counts = torch.bincount((rows + offs).reshape(-1), minlength=rows.shape[0] * nbins)
    count("host_syncs", BINCOUNT_SYNCS)
    return counts.reshape(*lead, nbins).float()


def _otsu_best_center(hist: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Inter-class-variance argmax -> bin-center threshold (skimage
    ``threshold_otsu`` core, the JAX indexing)."""
    w1 = torch.cumsum(hist, -1)
    w2 = w1[..., -1:] - w1
    cm = torch.cumsum(hist * centers, -1)
    total = cm[..., -1:]
    mean1 = cm / w1.clamp_min(1e-30)
    mean2 = (total - cm) / w2.clamp_min(1e-30)
    var12 = (w1 * w2 * (mean1 - mean2) ** 2)[..., :-1]
    # first index of the maximum, as jnp.argmax
    n = var12.shape[-1]
    pos = torch.arange(n, device=var12.device).expand_as(var12)
    best = torch.where(var12 == var12.amax(-1, keepdim=True), pos, n).amin(-1)
    return torch.gather(centers.expand_as(hist), -1, best[..., None])[..., 0]


def otsu_threshold(values: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """skimage ``threshold_otsu`` per row of ``values`` (..., P).

    uint8: one bin per integer value (skimage ignores ``nbins`` for integer
    images), an integer threshold.  Float: ``nbins`` even bins over
    [min, max], a bin-center threshold.  A constant row (skimage raises)
    returns its value."""
    if values.dtype == torch.uint8:
        idx = values.long()
        hist = _histogram(idx, 256)
        # bins outside [min, max] count 0 and have 0 inter-class variance,
        # so the argmax matches skimage's min..max bincount
        centers = torch.arange(256, dtype=torch.float32, device=values.device)
        thr = _otsu_best_center(hist, centers)
        vmin, vmax = idx.amin(-1).float(), idx.amax(-1).float()
        return torch.where(vmax > vmin, thr, vmin)
    v = values.float()
    vmin, vmax = v.amin(-1, keepdim=True), v.amax(-1, keepdim=True)
    width = (vmax - vmin) / nbins
    safe_w = torch.where(width > 0, width, torch.ones_like(width))
    idx = ((v - vmin) / safe_w).to(torch.int32).clamp(0, nbins - 1)
    hist = _histogram(idx, nbins)
    centers = vmin + (torch.arange(nbins, dtype=torch.float32, device=v.device) + 0.5) * safe_w
    thr = _otsu_best_center(hist, centers)
    return torch.where(width[..., 0] > 0, thr, vmin[..., 0])


def tissue_mask(img: torch.Tensor, rgb_min: int = 50) -> torch.Tensor:
    """Reference ``get_mask_image`` on (..., H, W, 3) uint8/float images ->
    (..., H, W) bool."""
    x = img.float()
    *lead, h, w, _ = img.shape
    # the channel thresholds keep the original dtype: uint8 takes skimage's
    # per-integer bins (the reference thresholds raw channels)
    flat = img.reshape(*lead, h * w, 3)
    thr = [otsu_threshold(flat[..., c].contiguous())[..., None, None] for c in range(3)]
    background = (x[..., 0] > thr[0]) & (x[..., 1] > thr[1]) & (x[..., 2] > thr[2])
    sat = rgb_to_saturation(img)
    s_thr = otsu_threshold(sat.reshape(*lead, h * w))[..., None, None]
    min_rgb = (x[..., 0] > rgb_min) & (x[..., 1] > rgb_min) & (x[..., 2] > rgb_min)
    return (sat > s_thr) & ~background & min_rgb


def tissue_mask_batch(imgs: torch.Tensor, rgb_min: int = 50) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W) bool."""
    return tissue_mask(imgs, rgb_min)


def _pad1(m: torch.Tensor) -> torch.Tensor:
    """Zero border of one pixel on the last two axes (scipy border_value=0)."""
    p = torch.zeros(m.shape[:-2] + (m.shape[-2] + 2, m.shape[-1] + 2), dtype=m.dtype,
                    device=m.device)
    p[..., 1:-1, 1:-1] = m
    return p


def binary_dilation(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """scipy.ndimage.binary_dilation with the default cross, on the last
    two axes."""
    m = mask.bool()
    for _ in range(iterations):
        p = _pad1(m)
        m = (p[..., 1:-1, 1:-1] | p[..., :-2, 1:-1] | p[..., 2:, 1:-1]
             | p[..., 1:-1, :-2] | p[..., 1:-1, 2:])
    return m


def binary_erosion(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """scipy.ndimage.binary_erosion with the default cross and a zero
    border, on the last two axes."""
    m = mask.bool()
    for _ in range(iterations):
        p = _pad1(m)
        m = (p[..., 1:-1, 1:-1] & p[..., :-2, 1:-1] & p[..., 2:, 1:-1]
             & p[..., 1:-1, :-2] & p[..., 1:-1, 2:])
    return m


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """skimage rgb2gray weights on [0, 1] floats."""
    x = _unit(img)
    return x[..., 0] * _GRAY[0] + x[..., 1] * _GRAY[1] + x[..., 2] * _GRAY[2]


def is_low_contrast(img: torch.Tensor, fraction_threshold: float = 0.05,
                    lower_percentile: float = 1,
                    upper_percentile: float = 99) -> torch.Tensor:
    """skimage ``is_low_contrast`` for (..., H, W, 3) uint8: the gray
    percentile range against the float dtype range [-1, 1] (width 2)."""
    gray = rgb_to_gray(img)
    flat = gray.flatten(-2)
    q = torch.tensor([lower_percentile / 100.0, upper_percentile / 100.0],
                     dtype=torch.float32, device=img.device)
    count("host_syncs")  # a list to the device is a blocking copy
    lo, hi = torch.quantile(flat, q, dim=-1)  # linear interpolation
    return (hi - lo) / 2.0 < fraction_threshold


def patch_keep_flags(patches_u8: torch.Tensor,
                     background_threshold: float = 0.2) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B,) bool: the dilated tissue mask covers more
    than ``background_threshold`` of the patch and it is not low contrast."""
    m = binary_dilation(tissue_mask(patches_u8), iterations=3)
    h, w = m.shape[-2:]
    frac_ok = m.sum((-2, -1)) > background_threshold * (h * w)
    return frac_ok & ~is_low_contrast(patches_u8)
