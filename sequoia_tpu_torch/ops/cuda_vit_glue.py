"""The ViT block's glue between its GEMMs: the kernels ``vit_swiglu`` and
``vit_residual_ln`` (``csrc/vit_glue.cu``) and their plain twins.

Replace no TPU kernel: the JAX package leaves the LayerScale residual and
the LayerNorm to XLA (``sequoia_tpu/models/uni_vit.py``) and has no Virchow2,
so no gate.  Both
ViT backbones of ``models/uni_vit.py`` call :func:`residual_ln` twice a block
(the attention's residual with LN2, the MLP's with the next block's LN1 or
the final norm); Virchow2's packed SwiGLU MLP calls :func:`swiglu` once a
block.

The mathematics and its rounding points, the same on both routes:

* the gate, fc1's (..., 2H) output -> (..., H): ``silu(a)`` of the first
  half in f32, rounded to the compute type, times the second half ``b``,
  rounded again (timm's ``GluMlp(gate_last=False)``);
* the residual ``x + out * gamma`` with ``torch.addcmul``'s f32 op-math
  (the product rounded in f32, then the sum), rounded to the compute type;
* the LayerNorm of that rounded sum over the last axis: f32 mean and biased
  variance, ``eps``, the affine, rounded to the compute type.

:func:`swiglu_plain` and :func:`residual_ln_plain` are those as PyTorch ops
(``F.silu``, ``torch.addcmul``, ``F.layer_norm``), exactly the block's ops
before the kernels; they run on the CPU, in f32 (the parity path) and at
widths the kernels do not compute.  :func:`vit_swiglu` and
:func:`vit_residual_ln` launch the kernels for CUDA tensors that are bf16,
contiguous, 16-byte aligned, of a width that is a multiple of 8 (the
residual's at most :data:`MAX_LN_WIDTH`), or raise ``ValueError``; on the
CPU they check the same and run the plain twin.  :func:`swiglu` and
:func:`residual_ln` pick the route from the device, the dtype and the width
(:func:`takes_swiglu`, :func:`takes_residual_ln`) and leave the rest to the
wrappers' checks.  Launches count in ``_build.LAUNCHES["vit_swiglu"]`` and
``["vit_residual_ln"]``, one a call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sequoia_tpu_torch import _build

#: the widest row vit_residual_ln holds in a warp's registers (8 chunks of 8
#: values a lane)
MAX_LN_WIDTH = 2048


def swiglu_plain(h: torch.Tensor) -> torch.Tensor:
    """The plain twin of the gate: ``silu(a) * b`` of ``h``'s halves."""
    a, b = h.chunk(2, dim=-1)
    return F.silu(a) * b


def residual_ln_plain(x: torch.Tensor, out: torch.Tensor, gamma: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of the residual: ``(x', LayerNorm(x'))`` for ``x' = x +
    out * gamma``."""
    x = torch.addcmul(x, out, gamma)
    return x, F.layer_norm(x, (x.shape[-1],), scale, bias, eps)


def takes_swiglu(h: torch.Tensor) -> bool:
    """Whether the kernel serves this gate: CUDA, bf16 and (..., 2H) with H
    a multiple of 8."""
    return h.is_cuda and h.dtype == torch.bfloat16 and h.shape[-1] % 16 == 0


def takes_residual_ln(x: torch.Tensor) -> bool:
    """Whether the kernel serves the residual on the stream ``x``: CUDA,
    bf16 and a width that is a multiple of 8, at most
    :data:`MAX_LN_WIDTH`."""
    d = x.shape[-1]
    return x.is_cuda and x.dtype == torch.bfloat16 and d % 8 == 0 and d <= MAX_LN_WIDTH


def swiglu(h: torch.Tensor) -> torch.Tensor:
    """The packed gate: :func:`vit_swiglu` where :func:`takes_swiglu` holds,
    else the plain twin."""
    return vit_swiglu(h) if takes_swiglu(h) else swiglu_plain(h)


def residual_ln(x, out, gamma, scale, bias, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual and the LayerNorm after it: :func:`vit_residual_ln`
    where :func:`takes_residual_ln` holds, else the plain twin."""
    if takes_residual_ln(x):
        return vit_residual_ln(x, out, gamma, scale, bias, eps)
    return residual_ln_plain(x, out, gamma, scale, bias, eps)


def _check(name: str, width: int, *ts: torch.Tensor) -> None:
    """``ValueError`` on what the kernel ``name`` does not take."""
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: tensors must be bf16, got {t.dtype}")
    if width % 8:
        raise ValueError(f"{name} kernel takes a width that is a multiple of 8, got {width}")
    for t in ts:
        if t.device != ts[0].device:
            raise ValueError(f"{name}: tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs 16-byte aligned tensors")


def _vit_swiglu_cuda(h: torch.Tensor) -> torch.Tensor:
    hid = h.shape[-1] // 2
    out = torch.empty((*h.shape[:-1], hid), dtype=h.dtype, device=h.device)
    rc = _build.library().sq_vit_swiglu(h.data_ptr(), out.data_ptr(), h.numel() // (2 * hid),
                                        hid, _build.stream_ptr(h))
    _build.check(rc, "vit_swiglu")
    _build.count_launch("vit_swiglu")
    return out


def _vit_residual_ln_cuda(x, out, gamma, scale, bias,
                          eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    d = x.shape[-1]
    xs, y = torch.empty_like(x), torch.empty_like(x)
    rc = _build.library().sq_vit_residual_ln(
        x.data_ptr(), out.data_ptr(), gamma.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        xs.data_ptr(), y.data_ptr(), x.numel() // d, d, eps, _build.stream_ptr(x))
    _build.check(rc, "vit_residual_ln")
    _build.count_launch("vit_residual_ln")
    return xs, y


def vit_swiglu(h: torch.Tensor) -> torch.Tensor:
    """:func:`swiglu_plain`'s function in one launch of ``csrc/vit_glue.cu``
    for a CUDA ``h``; the plain twin for a CPU one.  Raises ``ValueError``
    on what the kernel does not take."""
    if h.ndim < 1 or h.shape[-1] % 2 or h.numel() == 0:
        raise ValueError(f"vit_swiglu: h must be (..., 2H) with rows, got {tuple(h.shape)}")
    hid = h.shape[-1] // 2
    _check("vit_swiglu", hid, h)
    return _vit_swiglu_cuda(h) if h.is_cuda else swiglu_plain(h)


def vit_residual_ln(x, out, gamma, scale, bias,
                    eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`residual_ln_plain`'s function in one launch of
    ``csrc/vit_glue.cu`` for CUDA tensors; the plain twin for CPU ones.
    Raises ``ValueError`` on what the kernel does not take."""
    d = x.shape[-1]
    if (out.shape != x.shape or x.numel() == 0 or d > MAX_LN_WIDTH
            or any(t.shape != (d,) for t in (gamma, scale, bias))):
        raise ValueError(f"vit_residual_ln: x and out (..., D) with rows, D <= {MAX_LN_WIDTH}, "
                         f"gamma, scale and bias (D,); got {tuple(x.shape)}, "
                         f"{tuple(out.shape)}, {[tuple(t.shape) for t in (gamma, scale, bias)]}")
    _check("vit_residual_ln", d, x, out, gamma, scale, bias)
    if not x.is_cuda:
        return residual_ln_plain(x, out, gamma, scale, bias, eps)
    return _vit_residual_ln_cuda(x, out, gamma, scale, bias, eps)
