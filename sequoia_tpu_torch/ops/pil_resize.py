"""Bit-exact Pillow resize of uint8 images, in integer arithmetic on the
device.

Counterpart of ``sequoia_tpu/ops/pil_resize.py``.  The reference's UNI path
resizes each 256-px patch with ``torchvision.transforms.Resize(224)`` on a
PIL image: Pillow's BILINEAR resample with its implicit antialiasing (the
filter support grows with the downscale factor).

Pillow's 8-bit resample (``ImageResample.c``) is defined in integers: the
per-axis coefficients are quantized at ``PRECISION_BITS = 22``, each pass
sums ``pixel * k`` in int32, adds ``2**21``, shifts right by 22 and clips to
uint8, and the horizontal pass runs first with a uint8 intermediate image.
:func:`pil_coeff_matrix` is the JAX module's coefficient generator, copied.
:func:`resize_u8` does what Pillow does: each output pixel gathers its taps
(at most a few, banded: ``tests/test_pil_resize.py:53``) and sums them in
int32.  No float arithmetic touches a pixel, so the result is the same on
the CPU and the card, and bicubic (negative taps) and upscaling hold too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_PRECISION_BITS = 22  # Pillow: 32 - 8 - 2


def _filter(name: str):
    if name == "bilinear":
        def f(x):
            x = abs(x)
            return 1.0 - x if x < 1.0 else 0.0
        return f, 1.0
    if name == "bicubic":  # Pillow a = -0.5
        def f(x):
            x = abs(x)
            if x < 1.0:
                return ((1.5 * x - 2.5) * x) * x + 1.0
            if x < 2.0:
                return (((-0.5 * x + 2.5) * x) - 4.0) * x + 2.0
            return 0.0
        return f, 2.0
    raise ValueError(f"unknown filter {name!r}")


@functools.lru_cache(maxsize=64)
def pil_coeff_matrix(in_size: int, out_size: int,
                     filt: str = "bilinear") -> np.ndarray:
    """Pillow ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` as a dense
    (out_size, in_size) int32 matrix of the quantized coefficients
    (each row sums to ~2**22)."""
    f, support0 = _filter(filt)
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ss = 1.0 / filterscale

    m = np.zeros((out_size, in_size), np.int64)
    one = 1 << _PRECISION_BITS
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = np.array([f((x - center + 0.5) * ss) for x in range(xmin, xmax)])
        w /= w.sum()
        # Pillow quantizes half-away-from-zero (C truncation of +-0.5 + v)
        m[xx, xmin:xmax] = np.where(
            w < 0, np.ceil(w * one - 0.5), np.floor(w * one + 0.5))
    return m.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _taps(in_size: int, out_size: int, filt: str) -> tuple[np.ndarray, np.ndarray]:
    """The banded coefficient matrix as taps: ``(index (out, T) int64,
    coefficient (out, T) int32)``, T the most taps of any output pixel; a
    row with fewer taps is padded with coefficient 0 at its last tap."""
    m = pil_coeff_matrix(in_size, out_size, filt)
    nz = m != 0
    first = nz.argmax(1)
    last = in_size - 1 - nz[:, ::-1].argmax(1)
    t = int((last - first).max()) + 1
    idx = np.minimum(first[:, None] + np.arange(t), last[:, None])
    coef = np.take_along_axis(m, idx, 1) * (first[:, None] + np.arange(t) <= last[:, None])
    return idx.astype(np.int64), coef.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _device_taps(in_size: int, out_size: int, filt: str,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_taps` on ``device`` (the flat index and the coefficients),
    uploaded once, not on every batch."""
    idx, coef = _taps(in_size, out_size, filt)
    return torch.as_tensor(idx.ravel()).to(device), torch.as_tensor(coef).to(device)


def _pass(x_u8: torch.Tensor, in_size: int, out_size: int, filt: str, dim: int) -> torch.Tensor:
    """One resample pass along ``dim`` (-2: W, -3: H of an (..., H, W, C)
    tensor), Pillow's integer arithmetic: gather each output pixel's taps,
    sum ``pixel * k`` in int32, add 2**21, shift by 22, clip to uint8."""
    idx, coef = _device_taps(in_size, out_size, filt, x_u8.device)
    t = coef.shape[1]
    g = x_u8.index_select(dim, idx).to(torch.int32)
    shape = list(g.shape)
    shape[dim:dim + 1] = [out_size, t]
    g = g.reshape(shape)
    k = coef.reshape((out_size, t) + (1,) * (-dim - 1))
    s = (g * k).sum(dim, dtype=torch.int32) + (1 << (_PRECISION_BITS - 1))
    return (s >> _PRECISION_BITS).clamp_(0, 255).to(torch.uint8)


def resize_u8(images_u8: torch.Tensor, out_h: int, out_w: int,
              filt: str = "bilinear") -> torch.Tensor:
    """(..., H, W, C) uint8 -> (..., out_h, out_w, C) uint8, bit-exact
    Pillow semantics (horizontal pass first, uint8 intermediate)."""
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"resize_u8 takes uint8 images, got {images_u8.dtype}")
    in_h, in_w = images_u8.shape[-3], images_u8.shape[-2]
    x = images_u8
    if in_w != out_w:
        x = _pass(x, in_w, out_w, filt, -2)
    if in_h != out_h:
        x = _pass(x, in_h, out_h, filt, -3)
    return x
