"""The ViTs' attention, from the qkv GEMM's output to the tensor the proj
GEMM takes: the kernel ``vit_attention`` (``csrc/vit_attention.cu``) and its
plain twin.

Replaces no TPU kernel: the JAX package computes this attention with XLA
einsums (``sequoia_tpu/models/uni_vit.py:68-70``).  Both ViT backbones of
``models/uni_vit.py`` (UNI: 16 heads of 64, 197 tokens; Virchow2: 16 heads
of 80, 261 tokens) call :func:`attention` once a block.

The layout: ``qkv`` (B*N, 3*D), columns in ``(3, heads, dh)`` order, as the
qkv GEMM leaves it; the output (B*N, D), columns in ``(heads, dh)`` order,
as proj takes it.

The mathematics and its rounding points, the same on both routes:

* the scores ``q . k^T * dh^-0.5`` in f32: products of the compute type
  summed in f32, the scale an f32 multiply of the f32 sum.  For dh = 64 the
  plain twin multiplies q by the power of two 1/8 instead (the same bits,
  without a pass over the (N, N) scores);
* the softmax over each whole row in f32: its max, ``exp(s - max)``, their
  sum, a division;
* only the normalised probabilities are rounded to the compute type;
* ``p . v`` with products summed in f32 and one rounding of the output.

:func:`vit_attention_plain` is that recipe as separate PyTorch ops; it
runs on the CPU, in f32 (the parity path) and at any shape the kernel does
not take.
:func:`vit_attention` launches the kernel for CUDA tensors: bf16, dh in
:data:`HEAD_DIMS`, 1 <= N <= :data:`MAX_TOKENS`, contiguous and 16-byte
aligned, or it raises ``ValueError``; on the CPU it checks the same and runs
the plain twin.  :func:`attention` picks the route from what the input shows
(device, dtype, shape).  Launches count in ``_build.LAUNCHES
["vit_attention"]``, one a call.
"""

from __future__ import annotations

import math

import torch

from sequoia_tpu_torch import _build

#: the head widths the kernel is built for, and the most tokens it takes
HEAD_DIMS = (64, 80)
MAX_TOKENS = 512


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """``q . k^T * scale`` in f32 from (B, H, N, dh) operands of the compute
    type: bf16 products accumulate in f32 and come out in f32 (``out_dtype``
    on the card; on the CPU the same values from the operands widened).  A
    power-of-two scale (dh = 64: 1/8) multiplies q instead, which gives the
    same bits without a pass over the (N, N) scores."""
    b, h, n, dh = q.shape
    exact = math.frexp(scale)[0] == 0.5
    q3 = (q * scale if exact else q).reshape(b * h, n, dh)
    kt = k.reshape(b * h, n, dh).transpose(1, 2)
    if q.dtype != torch.float32 and q.is_cuda:
        s = torch.bmm(q3, kt, out_dtype=torch.float32)
    else:
        s = torch.bmm(q3.float(), kt.float())
    return (s if exact else s * scale).reshape(b, h, n, n)


def vit_attention_plain(qkv: torch.Tensor, b: int, n: int, heads: int) -> torch.Tensor:
    """The plain twin: (B*N, 3*D) -> (B*N, D) in ``qkv``'s type (the
    module's docstring), as separate PyTorch ops."""
    dh = qkv.shape[-1] // (3 * heads)
    qkv = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.softmax(_scores(q, k, dh ** -0.5), dim=-1).to(v.dtype)
    return torch.matmul(attn, v).transpose(1, 2).reshape(b * n, heads * dh)


def takes(qkv: torch.Tensor, n: int, dh: int) -> bool:
    """Whether the kernel serves this attention: CUDA, bf16, dh in
    :data:`HEAD_DIMS` and 1 <= n <= :data:`MAX_TOKENS`."""
    return (qkv.is_cuda and qkv.dtype == torch.bfloat16 and dh in HEAD_DIMS
            and 1 <= n <= MAX_TOKENS)


def attention(qkv: torch.Tensor, b: int, n: int, heads: int) -> torch.Tensor:
    """The block's attention: the kernel where :func:`takes` holds, else the
    plain twin."""
    if takes(qkv, n, qkv.shape[-1] // (3 * heads)):
        return vit_attention(qkv, b, n, heads)
    return vit_attention_plain(qkv, b, n, heads)


def _check(qkv: torch.Tensor, b: int, n: int, heads: int) -> int:
    """dh of a ``qkv`` the kernel takes; ``ValueError`` on anything else."""
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"vit_attention: qkv must be bf16, got {qkv.dtype}")
    if heads < 1 or qkv.ndim != 2 or qkv.shape[0] != b * n or qkv.shape[1] % (3 * heads):
        raise ValueError(f"vit_attention: qkv must be (B*N, 3*heads*dh) = ({b}*{n}, "
                         f"3*{heads}*dh), got {tuple(qkv.shape)}")
    dh = qkv.shape[1] // (3 * heads)
    if dh not in HEAD_DIMS or not 1 <= n <= MAX_TOKENS or b < 1:
        raise ValueError(f"vit_attention kernel takes dh in {HEAD_DIMS} and 1 <= N <= "
                         f"{MAX_TOKENS}, got dh={dh}, N={n}, B={b}")
    if not qkv.is_contiguous():
        raise ValueError("vit_attention: qkv must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("vit_attention kernel needs qkv 16-byte aligned")
    return dh


def _vit_attention_cuda(qkv: torch.Tensor, b: int, n: int, heads: int, dh: int) -> torch.Tensor:
    out = torch.empty((b * n, heads * dh), dtype=qkv.dtype, device=qkv.device)
    rc = _build.library().sq_vit_attention(qkv.data_ptr(), out.data_ptr(), b, n, heads, dh,
                                           dh ** -0.5, _build.stream_ptr(qkv))
    _build.check(rc, "vit_attention")
    _build.count_launch("vit_attention")
    return out


def vit_attention(qkv: torch.Tensor, b: int, n: int, heads: int) -> torch.Tensor:
    """:func:`vit_attention_plain`'s function in one launch of
    ``csrc/vit_attention.cu`` for a CUDA ``qkv``; the plain twin for a CPU
    one.  Raises ``ValueError`` on what the kernel does not take."""
    dh = _check(qkv, b, n, heads)
    if not qkv.is_cuda:
        return vit_attention_plain(qkv, b, n, heads)
    return _vit_attention_cuda(qkv, b, n, heads, dh)
