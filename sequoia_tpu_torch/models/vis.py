"""ViS, the SEQUOIA SummaryMixing aggregator: ``(B, N, D)`` cluster features
-> ``(B, G)`` gene predictions.

Counterpart of ``sequoia_tpu/models/vis.py``, with the same stacked
parameter layout (a dict of tensors, block parameters stacked on a leading
``depth`` axis, weights in ``(in, out)`` math layout), so a JAX parameter
tree carries across with ``models.convert.vis_params_from_numpy`` and a torch
reference state dict with ``models.convert.vis_from_torch``.

Per block: all heads' ``f``/``s`` projections as one GEMM each, per-head
LayerNorm + GELU, the token-mean summary branch, the per-head combine as an
einsum over heads, projection + residual, then pre-LN FeedForward +
residual.  This is the plain path; serving at B = 1 runs the blocks through
the fused kernel instead (``ops/cuda_vis.vis_apply_fused``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from sequoia_tpu_torch.ops.nn import (compute_dtype, einsum, gelu, layer_norm,
                                      linear, slice_linear_outputs)
from sequoia_tpu_torch.utils import torch_init

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViSConfig:
    """Architecture hyperparameters (defaults = reference ``src/main.py:144-147``).

    ``compute_dtype``: None keeps the f32 parity path; "bfloat16" runs the
    blocks in bf16 with f32 accumulation and f32 LayerNorm/head output."""

    num_outputs: int
    input_dim: int
    depth: int = 6
    nheads: int = 16
    dim_f: int = 64
    dim_s: int = 64
    dim_c: int = 64
    num_clusters: int = 100
    compute_dtype: str | None = None

    @property
    def proj_in(self) -> int:
        return self.nheads * self.dim_c


def init(cfg: ViSConfig, gen: torch.Generator, dtype=torch.float32) -> Params:
    """Fresh parameters with torch-default init distributions, on the
    generator's device."""
    d, h, depth = cfg.input_dim, cfg.nheads, cfg.depth

    def stack_linears(n, fan_in, fan_out):
        pairs = [torch_init.linear_params(gen, fan_in, fan_out, dtype) for _ in range(n)]
        return (torch.stack([w for w, _ in pairs]),
                torch.stack([b for _, b in pairs]))

    def fused_heads(width):
        # one Linear per head (as torch draws them), fused to (depth, D, H*width)
        w, b = stack_linears(depth * h, d, width)
        w = w.reshape(depth, h, d, width).permute(0, 2, 1, 3).reshape(depth, d, h * width)
        return w.contiguous(), b.reshape(depth, h * width)

    blocks: dict[str, torch.Tensor] = {}
    blocks["wf"], blocks["bf"] = fused_heads(cfg.dim_f)
    blocks["ws"], blocks["bs"] = fused_heads(cfg.dim_s)
    wc, bc = stack_linears(depth * h, cfg.dim_f + cfg.dim_s, cfg.dim_c)
    blocks["wc"] = wc.reshape(depth, h, cfg.dim_f + cfg.dim_s, cfg.dim_c)
    blocks["bc"] = bc.reshape(depth, h, cfg.dim_c)
    dev = gen.device
    blocks["ln_f_scale"] = torch.ones((depth, h, cfg.dim_f), dtype=dtype, device=dev)
    blocks["ln_f_bias"] = torch.zeros((depth, h, cfg.dim_f), dtype=dtype, device=dev)
    blocks["ln_s_scale"] = torch.ones((depth, h, cfg.dim_s), dtype=dtype, device=dev)
    blocks["ln_s_bias"] = torch.zeros((depth, h, cfg.dim_s), dtype=dtype, device=dev)
    blocks["wproj"], blocks["bproj"] = stack_linears(depth, cfg.proj_in, d)
    blocks["ln_ff_scale"] = torch.ones((depth, d), dtype=dtype, device=dev)
    blocks["ln_ff_bias"] = torch.zeros((depth, d), dtype=dtype, device=dev)
    # FeedForward hidden dim == input_dim (reference tformer_lin.py:71)
    blocks["w1"], blocks["b1"] = stack_linears(depth, d, d)
    blocks["w2"], blocks["b2"] = stack_linears(depth, d, d)

    head_w, head_b = torch_init.linear_params(gen, d, cfg.num_outputs, dtype)
    return {
        "pos_emb": torch_init.randn(gen, (cfg.num_clusters, d), dtype),
        "blocks": blocks,
        "head_ln_scale": torch.ones((d,), dtype=dtype, device=dev),
        "head_ln_bias": torch.zeros((d,), dtype=dtype, device=dev),
        "head_w": head_w,
        "head_b": head_b,
    }


def _block(cfg: ViSConfig, x: torch.Tensor, bp: dict[str, torch.Tensor]) -> torch.Tensor:
    b, n, _ = x.shape
    h = cfg.nheads

    local = linear(x, bp["wf"], bp["bf"]).reshape(b, n, h, cfg.dim_f)
    local = gelu(layer_norm(local, bp["ln_f_scale"], bp["ln_f_bias"]))

    summ = linear(x, bp["ws"], bp["bs"]).reshape(b, n, h, cfg.dim_s)
    summ = summ.mean(1)  # (B, H, ds): over all N tokens
    summ = gelu(layer_norm(summ, bp["ln_s_scale"], bp["ln_s_bias"]))
    summ = summ[:, None].expand(b, n, h, cfg.dim_s)

    cat = torch.cat([local, summ], -1)  # (B, N, H, df+ds)
    c = einsum("bnhi,hio->bnho", cat, bp["wc"]) + bp["bc"]
    c = gelu(c).to(x.dtype)

    x = linear(c.reshape(b, n, h * cfg.dim_c), bp["wproj"], bp["bproj"]) + x
    y = layer_norm(x, bp["ln_ff_scale"], bp["ln_ff_bias"])
    y = gelu(linear(y, bp["w1"], bp["b1"]))
    return x + linear(y, bp["w2"], bp["b2"])


def _head_norm(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token mean and LayerNorm in f32: ``(B, N, D)`` -> the gene head's
    ``(B, D)`` input."""
    x = tokens.float().mean(1)
    return layer_norm(x, params["head_ln_scale"], params["head_ln_bias"])


def head(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token mean, LayerNorm and the (D, G) gene head, in f32:
    ``(B, N, D)`` -> ``(B, G)``."""
    return linear(_head_norm(params, tokens), params["head_w"], params["head_b"])


def head_input(cfg: ViSConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Everything before the gene head: ``(B, N, D)`` cluster features ->
    the ``(B, D)`` f32 rows that ``head_w``/``head_b`` map to genes."""
    if cfg.compute_dtype is not None:
        x = x.to(compute_dtype(cfg.compute_dtype))
    x = x + params["pos_emb"].to(x.dtype)
    for i in range(cfg.depth):
        x = _block(cfg, x, {k: v[i] for k, v in params["blocks"].items()})
    return _head_norm(params, x)


def apply(cfg: ViSConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Forward pass: ``(B, N, D)`` cluster features -> ``(B, G)`` predictions."""
    return linear(head_input(cfg, params, x), params["head_w"], params["head_b"])


def slice_head(cfg: ViSConfig, params: Params, indices) -> tuple[ViSConfig, Params]:
    """Restrict the output head to a gene panel (a linear head commutes with
    output selection)."""
    new = dict(params)
    new["head_w"], new["head_b"], n = slice_linear_outputs(
        params["head_w"], params["head_b"], indices, cfg.num_outputs)
    return dataclasses.replace(cfg, num_outputs=n), new


def replace_head(cfg: ViSConfig, params: Params, num_outputs: int,
                 gen: torch.Generator) -> tuple[ViSConfig, Params]:
    """GTEx -> TCGA transfer: a fresh LayerNorm + Linear output head of
    ``num_outputs``, drawn from ``gen`` with torch Linear defaults, in the
    params' dtype and on the generator's device (``sequoia_tpu/models/vis.py``
    ``replace_head``)."""
    d = cfg.input_dim
    dt = params["head_w"].dtype
    new = dict(params)
    new["head_w"], new["head_b"] = torch_init.linear_params(gen, d, num_outputs, dt)
    new["head_ln_scale"] = torch.ones((d,), dtype=dt, device=gen.device)
    new["head_ln_bias"] = torch.zeros((d,), dtype=dt, device=gen.device)
    return dataclasses.replace(cfg, num_outputs=num_outputs), new
