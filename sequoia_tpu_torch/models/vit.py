"""ViT, the softmax-attention aggregator: ``(B, N, D)`` cluster features ->
``(B, G)`` gene predictions.

Counterpart of ``sequoia_tpu/models/vit.py`` (reference ``src/vit.py:37-115``,
a lucidrains simple-ViT derivative): a learned 1-D position embedding over
``num_clusters`` tokens, ``depth`` pre-LN blocks of multi-head softmax
attention (qkv and output projections without bias) and pre-LN FeedForward,
the token mean, then LayerNorm + Linear.  The attention scale is
``dim_head ** -0.5``.

The same stacked parameter layout as the JAX package (block parameters on a
leading ``depth`` axis, weights ``(in, out)``), so a JAX tree carries across
with ``models.convert.vit_params_from_numpy``.  The attention stays in the
einsum form with an f32 softmax, as JAX's does: the scores leave their
product in f32 and the probabilities are cast to the value type.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from sequoia_tpu_torch.ops.nn import (compute_dtype, einsum, gelu, layer_norm, linear,
                                      slice_linear_outputs)
from sequoia_tpu_torch.utils import torch_init

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Defaults = reference ``src/main.py:141-143``.  ``compute_dtype``: None
    keeps the f32 parity path; "bfloat16" runs the blocks in bf16 with f32
    accumulation and f32 LayerNorm, softmax and head."""

    num_outputs: int
    dim: int
    depth: int = 6
    heads: int = 16
    dim_head: int = 64
    mlp_dim: int = 2048
    num_clusters: int = 100
    compute_dtype: str | None = None

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head


def init(cfg: ViTConfig, gen: torch.Generator, dtype=torch.float32) -> Params:
    """Fresh parameters with torch-default init distributions, on the
    generator's device."""
    d, inner, depth, dev = cfg.dim, cfg.inner_dim, cfg.depth, gen.device

    def stack(fan_in, fan_out, bias=True):
        pairs = [torch_init.linear_params(gen, fan_in, fan_out, dtype) for _ in range(depth)]
        w = torch.stack([w for w, _ in pairs])
        return (w, torch.stack([b for _, b in pairs])) if bias else w

    ones = lambda *s: torch.ones(s, dtype=dtype, device=dev)  # noqa: E731
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=dev)  # noqa: E731
    blocks: dict[str, torch.Tensor] = {
        "ln_attn_scale": ones(depth, d),
        "ln_attn_bias": zeros(depth, d),
        # to_qkv / to_out are bias-free Linears (reference vit.py:59-60)
        "w_qkv": stack(d, 3 * inner, bias=False),
        "w_out": stack(inner, d, bias=False),
        "ln_ff_scale": ones(depth, d),
        "ln_ff_bias": zeros(depth, d),
    }
    blocks["w1"], blocks["b1"] = stack(d, cfg.mlp_dim)
    blocks["w2"], blocks["b2"] = stack(cfg.mlp_dim, d)
    head_w, head_b = torch_init.linear_params(gen, d, cfg.num_outputs, dtype)
    return {
        "pos_emb": torch_init.randn(gen, (cfg.num_clusters, d), dtype),
        "blocks": blocks,
        "head_ln_scale": ones(d),
        "head_ln_bias": zeros(d),
        "head_w": head_w,
        "head_b": head_b,
    }


def _block(cfg: ViTConfig, x: torch.Tensor, bp: dict[str, torch.Tensor]) -> torch.Tensor:
    b, n, _ = x.shape
    h, dh = cfg.heads, cfg.dim_head

    y = layer_norm(x, bp["ln_attn_scale"], bp["ln_attn_bias"])
    qkv = linear(y, bp["w_qkv"])  # (B, N, 3*H*dh), torch chunk order [q|k|v]
    q, k, v = (t.reshape(b, n, h, dh).transpose(1, 2) for t in qkv.chunk(3, dim=-1))

    scores = einsum("bhnd,bhmd->bhnm", q, k) * (dh ** -0.5)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    out = einsum("bhnm,bhmd->bhnd", attn, v).to(x.dtype)
    x = linear(out.transpose(1, 2).reshape(b, n, h * dh), bp["w_out"]) + x

    y = layer_norm(x, bp["ln_ff_scale"], bp["ln_ff_bias"])
    y = gelu(linear(y, bp["w1"], bp["b1"]))
    return x + linear(y, bp["w2"], bp["b2"])


def head_input(cfg: ViTConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Everything before the gene head: ``(B, N, D)`` cluster features ->
    the ``(B, D)`` f32 rows that ``head_w``/``head_b`` map to genes."""
    if cfg.compute_dtype is not None:
        x = x.to(compute_dtype(cfg.compute_dtype))
    x = x + params["pos_emb"].to(x.dtype)
    for i in range(cfg.depth):
        x = _block(cfg, x, {k: v[i] for k, v in params["blocks"].items()})
    return layer_norm(x.float().mean(1), params["head_ln_scale"], params["head_ln_bias"])


def apply(cfg: ViTConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Forward pass: ``(B, N, D)`` cluster features -> ``(B, G)`` predictions."""
    return linear(head_input(cfg, params, x), params["head_w"], params["head_b"])


def slice_head(cfg: ViTConfig, params: Params, indices) -> tuple[ViTConfig, Params]:
    """Restrict the output head to a gene panel."""
    new = dict(params)
    new["head_w"], new["head_b"], n = slice_linear_outputs(
        params["head_w"], params["head_b"], indices, cfg.num_outputs)
    return dataclasses.replace(cfg, num_outputs=n), new


def replace_head(cfg: ViTConfig, params: Params, num_outputs: int,
                 gen: torch.Generator) -> tuple[ViTConfig, Params]:
    """GTEx -> TCGA transfer: a fresh LayerNorm + Linear output head of
    ``num_outputs``, drawn from ``gen``, in the params' dtype on the
    generator's device."""
    d, dt = cfg.dim, params["head_w"].dtype
    new = dict(params)
    new["head_w"], new["head_b"] = torch_init.linear_params(gen, d, num_outputs, dt)
    new["head_ln_scale"] = torch.ones((d,), dtype=dt, device=gen.device)
    new["head_ln_bias"] = torch.zeros((d,), dtype=dt, device=gen.device)
    return dataclasses.replace(cfg, num_outputs=num_outputs), new


def posemb_sincos_2d(h: int, w: int, dim: int, temperature: float = 10000.0,
                     dtype=torch.float32) -> torch.Tensor:
    """The 2-D sin/cos position embedding of the reference API (unused by
    its pipeline): ``(h*w, dim)``."""
    assert dim % 4 == 0, "feature dimension must be multiple of 4 for sincos emb"
    y, x = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    omega = torch.arange(dim // 4) / (dim // 4 - 1)
    omega = 1.0 / (temperature ** omega)
    y = y.reshape(-1)[:, None] * omega[None, :]
    x = x.reshape(-1)[:, None] * omega[None, :]
    return torch.cat([x.sin(), x.cos(), y.sin(), y.cos()], dim=1).to(dtype)
