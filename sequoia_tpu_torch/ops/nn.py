"""Elementary NN ops with exact PyTorch numerics, and the port's precision
rules.

Counterpart of ``sequoia_tpu/ops/nn.py``.  Same conventions: weights in math
layout ``(in_features, out_features)``, LayerNorm with biased variance and
eps 1e-5, exact-erf GELU.

Precision (:func:`precision`): the f32 parity path of the JAX package pins
``Precision.HIGHEST``; here that means TF32 off for both matmuls and cuDNN
convolutions.  In bf16 mode operands are bf16 with f32 accumulation, and
LayerNorm, GELU, the token mean and the gene head stay in f32.  A product of
two bf16 values is exact in f32, so ``linear`` widens its bf16 operands and
multiplies in f32: bf16 operands, f32 accumulation, one rounding at the end,
as ``preferred_element_type=float32`` gives in JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5

_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16, torch.float32: torch.float32,
           torch.bfloat16: torch.bfloat16}


def compute_dtype(name) -> torch.dtype:
    """``None`` / ``"float32"`` / ``"bfloat16"`` (or the torch dtype) ->
    the torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {name!r}") from None


def precision(name=None) -> torch.dtype:
    """Set the port's precision rules and return the compute dtype for
    ``name``: TF32 off for matmuls and cuDNN (f32 means IEEE f32 on the card,
    cuDNN's default is TF32), whatever the compute dtype, since the f32 parts
    of the bf16 mode stay f32 too; and bf16 matmuls accumulate in f32 all
    the way (cuBLAS may otherwise reduce split-K partials in bf16)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return compute_dtype(name)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU, ``torch.nn.GELU()``'s default."""
    return F.gelu(x)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis in f32 with torch semantics (biased
    variance); ``scale``/``bias`` may carry extra leading axes (per-head
    ``(H, D)`` on an ``(..., H, D)`` activation)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w (+ b)`` with f32 accumulation; f32 weights are cast down to a
    bf16 activation's type first.  Returns f32 for an f32 ``x``, else
    ``x.dtype`` (rounded once, after the bias)."""
    y = torch.matmul(x.float(), w.to(x.dtype).float())
    if b is not None:
        y = y + b.float()
    return y if x.dtype == torch.float32 else y.to(x.dtype)


def einsum(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with :func:`linear`'s policy: operands in the first
    operand's type, f32 accumulation, f32 result."""
    dt = ops[0].dtype
    return torch.einsum(spec, *(o.to(dt).float() for o in ops))


def slice_linear_outputs(w: torch.Tensor, b: torch.Tensor, indices,
                         num_outputs: int):
    """Gather output columns of a ``(fan_in, out)`` head for gene-panel
    serving: ``(w', b', n_panel)``, with the bounds checked first."""
    idx = np.asarray(indices, np.int64)
    if idx.ndim != 1 or idx.shape[0] == 0:
        raise ValueError("slice_head needs a non-empty 1-D index list")
    if (idx < 0).any() or (idx >= num_outputs).any():
        raise ValueError(f"slice_head indices out of range for "
                         f"num_outputs={num_outputs}")
    t = torch.as_tensor(idx, device=w.device)
    return w[:, t], b[t], int(idx.shape[0])
