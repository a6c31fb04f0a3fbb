"""The arithmetic every reference product goes through, in one of three
precisions: ``float32`` (IEEE f32 on the card: TF32 off), ``tf32`` (TF32 on,
the step below f32) and ``fp8`` (each operand rounded to float8 e4m3 with a
per-tensor scale, then multiplied in f32: the step below bf16)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


@contextlib.contextmanager
def precision(mode: str):
    """TF32 on for ``tf32``, off otherwise, for the products inside."""
    if mode not in ("float32", "tf32", "fp8"):
        raise ValueError(f"unknown precision {mode!r}")
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def quant(x: torch.Tensor, mode: str) -> torch.Tensor:
    """``x`` in f32, rounded through float8 e4m3 with a per-tensor scale
    under ``fp8``."""
    x = x.float()
    if mode != "fp8":
        return x
    amax = x.abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    return torch.matmul(quant(a, mode), quant(b, mode))


def conv2d(x: torch.Tensor, w: torch.Tensor, mode: str, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    return F.conv2d(quant(x, mode), quant(w, mode), stride=stride, padding=padding)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32, biased variance."""
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias
