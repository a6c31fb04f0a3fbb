"""JPEG chroma upsampling and YCbCr -> RGB on the device, bit-exact against
libjpeg.

Counterpart of ``sequoia_tpu/ops/ycbcr.py``.  Real whole-slide images
(Aperio SVS) store JPEG tiles as chroma-subsampled YCbCr: 1.5 bytes a pixel
at 4:2:0 against the 3 they expand to as RGB.  The native reader returns
those planes (``native.NativeTiffReader.read_regions_ycbcr``), so the raw
serving modes (``serve.SlidePredictor``, ``'ycbcr'`` and ``'mosaic'``) send
half the bytes to the device and rebuild RGB there, with the two libjpeg
algorithms that libtiff's ``JPEGCOLORMODE_RGB`` decode runs:

* ``jdsample.c`` ``h2v2_fancy_upsample`` / ``h2v1_fancy_upsample``: a
  triangle filter ``(3 * near + far + bias) >> shift`` with per-parity
  biases and clamped edge rows and columns.  Each TIFF tile is its own JPEG
  image, so the clamping is per tile.
* ``jdcolor.c`` ``ycc_rgb_convert``: 16-bit fixed point (SCALEBITS = 16),
  round half up, clamped to [0, 255].

Everything is int32 elementwise work on torch tensors, on the CPU or the
card (widened from uint8 before any arithmetic; ``>>`` on int32 is
arithmetic, the C tables' floor for the negative green term).  The JAX
package leaves this to XLA, which fuses it into the backbone program; no
TPU kernel is behind it, so plain PyTorch ops on the device are the port.
Subsamplings (2, 2), (2, 1) and (1, 1) are supported; any other raises
``ValueError``.
"""

from __future__ import annotations

import torch

# jdcolor.c fixed-point constants (SCALEBITS = 16)
_SCALE = 16
_HALF = 1 << (_SCALE - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALE) + 0.5)


_FIX_RCR = _fix(1.40200)
_FIX_BCB = _fix(1.77200)
_FIX_GCB = _fix(0.34414)
_FIX_GCR = _fix(0.71414)


def planar_sizes(h: int, w: int, sh: int, sv: int) -> tuple[int, int]:
    """(luma bytes, chroma bytes per plane) of one planar region."""
    return h * w, (h // sv) * (w // sh)


def split_planar(buf: torch.Tensor, h: int, w: int, sh: int, sv: int):
    """(N, h*w + 2*(h//sv)*(w//sh)) uint8 planar Y ++ Cb ++ Cr (the native
    reader's ``read_regions_ycbcr`` rows) -> (y, cb, cr) int32 of shapes
    (N, h, w) and 2 x (N, h//sv, w//sh)."""
    ny, nc = planar_sizes(h, w, sh, sv)
    y = buf[:, :ny].reshape(-1, h, w).to(torch.int32)
    cb = buf[:, ny:ny + nc].reshape(-1, h // sv, w // sh).to(torch.int32)
    cr = buf[:, ny + nc:].reshape(-1, h // sv, w // sh).to(torch.int32)
    return y, cb, cr


def _fancy_h(vals: torch.Tensor, bias_even: int, bias_odd: int, shift: int) -> torch.Tensor:
    """The horizontal triangle filter over (..., W) int32 column values ->
    (..., 2W), even and odd output columns interleaved."""
    last = torch.cat([vals[..., :1], vals[..., :-1]], dim=-1)
    nxt = torch.cat([vals[..., 1:], vals[..., -1:]], dim=-1)
    even = (3 * vals + last + bias_even) >> shift
    odd = (3 * vals + nxt + bias_odd) >> shift
    even[..., 0] = (4 * vals[..., 0] + bias_even) >> shift
    odd[..., -1] = (4 * vals[..., -1] + bias_odd) >> shift
    return torch.stack([even, odd], dim=-1).reshape(*vals.shape[:-1], 2 * vals.shape[-1])


def fancy_upsample_h2v2(p: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v2_fancy_upsample: (N, H, W) int32 -> (N, 2H, 2W) int32."""
    h = p.shape[-2]
    rows = torch.arange(2 * h, device=p.device)
    inr = rows // 2
    near = torch.where(rows % 2 == 0, inr - 1, inr + 1).clamp(0, h - 1)
    colsum = 3 * p.index_select(-2, inr) + p.index_select(-2, near)
    return _fancy_h(colsum, 8, 7, 4)


def fancy_upsample_h2v1(p: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v1_fancy_upsample: (N, H, W) int32 -> (N, H, 2W) int32.
    The edge columns are the plain sample: (4v + 1) >> 2 and (4v + 2) >> 2
    are v for v in [0, 255]."""
    return _fancy_h(p, 1, 2, 2)


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """jdcolor.c ycc_rgb_convert: full-resolution int32 planes -> uint8 RGB
    (N, H, W, 3)."""
    cbm = cb - 128
    crm = cr - 128
    r = y + ((_FIX_RCR * crm + _HALF) >> _SCALE)
    b = y + ((_FIX_BCB * cbm + _HALF) >> _SCALE)
    g = y + ((-_FIX_GCB * cbm - _FIX_GCR * crm + _HALF) >> _SCALE)
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def mask_to_valid(rgb: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """Zero the pixels past each image's in-bounds extent: (N, P, P, 3)
    uint8 and per-image valid (width, height) int32 (N, 2) -> masked images.

    The RGB decode fills a region past the level's edge with zeros
    (``tiffreader.cpp read_region_impl``); this keeps the raw-plane
    reconstructions bit-exact with it, and turns a batch's zero-``wh``
    padding rows black, which the tissue screen drops."""
    ps = rgb.shape[-2]
    cols = torch.arange(ps, dtype=torch.int32, device=rgb.device)
    wh = wh.to(device=rgb.device, dtype=torch.int32)
    valid = ((cols[None, None, :] < wh[:, 0, None, None])
             & (cols[None, :, None] < wh[:, 1, None, None]))
    return torch.where(valid[..., None], rgb, torch.zeros((), dtype=torch.uint8,
                                                          device=rgb.device))


def planar_to_rgb(buf: torch.Tensor, h: int, w: int, sh: int, sv: int) -> torch.Tensor:
    """The whole reconstruction: (N, planar bytes) uint8 -> (N, h, w, 3)
    uint8 RGB, bit-exact against the native reader's RGB decode."""
    if (sh, sv) not in ((2, 2), (2, 1), (1, 1)):
        raise ValueError(f"unsupported subsampling {(sh, sv)}")
    y, cb, cr = split_planar(buf, h, w, sh, sv)
    if (sh, sv) == (2, 2):
        cb, cr = fancy_upsample_h2v2(cb), fancy_upsample_h2v2(cr)
    elif (sh, sv) == (2, 1):
        cb, cr = fancy_upsample_h2v1(cb), fancy_upsample_h2v1(cr)
    return ycc_to_rgb(y, cb, cr)
