"""HE2RNA, the MLP (1x1-conv) aggregation baseline: ``(B, T, D)`` tile
features -> ``(B, G)`` gene predictions.

Counterpart of ``sequoia_tpu/models/he2rna.py`` (reference
``src/he2rna.py:42-106``, itself derived from Owkin's HE2RNA): a per-tile
scoring MLP ``D -> 256 -> 256 -> G`` (a 1x1 Conv1d is a dense layer over the
feature axis) with ReLU and Dropout(0.5) between the layers, then a top-k
masked mean over the tiles:

* ``mask`` marks the tiles whose feature max is > 0 (zero-padded tiles drop
  out);
* training draws one ``k`` from ``ks`` per forward pass; eval averages the
  predictions of every ``k`` in ``ks``, over tile scores computed and sorted
  once;
* the masked mean divides by ``sum(mask[:, :k])``: the mask of the FIRST
  ``k`` tiles in input order, not of the top-k tiles (the reference's quirk,
  kept: it rescales by the padded-tile count when k exceeds the real tiles);
* the reference's ReLU on predictions at eval/predict time lives in the
  caller (``train/he2rna_fit.py``, ``serve.py``), as in the reference.

The top-k masked mean is a ``torch.autograd.Function`` with the JAX custom
VJP's backward: ``g * mask[:k] / denom`` lands on the selected tile of each
(row, gene).  Top-k indices are distinct within a row, so one ``scatter_``
into a zeroed ``(B, G, T)`` gives the JAX one-hot contraction's value exactly
(one non-zero term an element) without its ``(B, G, k, T)`` one-hot.  A
padded batch row (denominator 0) predicts 0 and gets 0 gradients, not NaN.

Random draws: dropout masks come from ``gen``, a generator on the
activations' device; the train-mode ``k`` from ``k_gen``, a CPU generator,
so picking the branch needs no device sync.  They differ from the JAX
package's PRNG draws by nature.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from sequoia_tpu_torch.ops.nn import linear, slice_linear_outputs
from sequoia_tpu_torch.utils import torch_init

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class HE2RNAConfig:
    """Defaults = reference ``src/he2rna.py:392-394``."""

    input_dim: int
    output_dim: int
    layers: tuple[int, ...] = (256, 256)
    ks: tuple[int, ...] = (1, 2, 5, 10, 20, 50, 100)
    dropout: float = 0.5


def ks_for_tokens(tokens: int | None) -> tuple[int, ...]:
    """The reference k sweep (``he2rna.py:83``) filtered to k <= the store's
    token count (there is no top k of fewer than k tiles); None or 0 means
    the contract's 100 tokens."""
    t = tokens or 100
    return tuple(k for k in HE2RNAConfig.ks if k <= t) or (1,)


def init(cfg: HE2RNAConfig, gen: torch.Generator, dtype=torch.float32,
         bias_init=None) -> Params:
    """Fresh parameters (torch Linear/Conv1d default distributions) on the
    generator's device.  ``bias_init``: an optional (G,) output bias (the
    reference constructor's, seeding the head with mean expression)."""
    dims = (cfg.input_dim,) + tuple(cfg.layers) + (cfg.output_dim,)
    ws, bs = [], []
    for din, dout in zip(dims[:-1], dims[1:]):
        w, b = torch_init.linear_params(gen, din, dout, dtype)
        ws.append(w)
        bs.append(b)
    if bias_init is not None:
        bs[-1] = torch.as_tensor(bias_init, dtype=dtype).to(gen.device)
    return {"w": ws, "b": bs}


def scores_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float32 if x.dtype == torch.float32 else x.dtype


def tile_scores(cfg: HE2RNAConfig, params: Params, x: torch.Tensor, *, train: bool = False,
                gen: torch.Generator | None = None) -> torch.Tensor:
    """Per-tile gene scores ``(B, T, D) -> (B, T, G)`` before masking;
    dropout (p = ``cfg.dropout``, drawn from ``gen``) after each hidden ReLU
    when ``train``."""
    ws, bs = params["w"], params["b"]
    drop = train and cfg.dropout > 0
    if drop and gen is None:
        raise ValueError("train-mode dropout needs a generator on the activations' device")
    for w, b in zip(ws[:-1], bs[:-1]):
        x = torch.relu(linear(x, w, b))
        if drop:
            keep = torch.empty_like(x).bernoulli_(1.0 - cfg.dropout, generator=gen)
            x = torch.where(keep.bool(), x / (1.0 - cfg.dropout), 0.0)
    return linear(x, ws[-1], bs[-1])


def _top(mt: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of each row of ``mt`` (B, G, T) and their tile
    indices, in descending order: one sort of each row, sliced.  Rows are
    short (T = 100 tiles), where one in-place sort of each row costs the
    card less than ``torch.topk``'s radix select and its sort of the k
    (PERF.md §6)."""
    vals, idx = torch.sort(mt, dim=2, descending=True)
    return vals[..., :k], idx[..., :k]


def _masked_mean(vals: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """(B, G, k) sorted top values and (B, T) mask -> (B, G): the sum over
    the first ``k`` tiles' mask, over that mask's count; 0 where it is 0."""
    m = mask[:, :k]
    denom = m.sum(1)
    num = (vals * m[:, None, :]).sum(2)
    return torch.where(denom[:, None] > 0, num / denom.clamp_min(1.0)[:, None], 0.0)


class TopkMaskedMean(torch.autograd.Function):
    """(B, G, T) masked scores, (B, T) mask, k -> (B, G) top-k masked mean,
    with the JAX custom VJP's backward (``he2rna.py:124-143``) as a scatter."""

    @staticmethod
    def forward(ctx, mt: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
        vals, idx = _top(mt, k)
        ctx.save_for_backward(idx.contiguous(), mask)  # not a view of the whole sort
        ctx.k, ctx.shape = k, mt.shape
        return _masked_mean(vals, mask, k)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        idx, mask = ctx.saved_tensors
        m = mask[:, :ctx.k].to(g.dtype)
        denom = m.sum(1)
        w = torch.where(denom[:, None] > 0, m / denom.clamp_min(1.0)[:, None], 0.0)
        upd = g[:, :, None] * w[:, None, :]  # (B, G, k)
        dmt = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device).scatter_(2, idx, upd)
        return dmt, None, None


def _masked_scores(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, T, G) scores -> (B, G, T) scores with the padded tiles zeroed, the
    tile axis last and contiguous for the sort."""
    return (scores * mask[:, :, None]).transpose(1, 2).contiguous()


def topk_masked_mean(scores: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Reference ``forward_fixed_k``: top-k over the tiles of the masked
    scores, over the mask count of the first ``k`` tiles."""
    return TopkMaskedMean.apply(_masked_scores(scores, mask), mask, int(k))


def apply(cfg: HE2RNAConfig, params: Params, x: torch.Tensor, *, train: bool = False,
          gen: torch.Generator | None = None,
          k_gen: torch.Generator | None = None) -> torch.Tensor:
    """Forward pass ``(B, T, D) -> (B, G)``.

    Train mode draws ``k`` from ``cfg.ks`` with ``k_gen`` (a CPU generator;
    reference ``forward``'s ``np.random.choice(self.ks)``) and the dropout
    masks from ``gen``.  Eval averages every k's top-k masked mean; one sort
    serves them all (the first k of the sorted values are the top k)."""
    mask = (x.amax(2) > 0).to(scores_dtype(x))  # (B, T)
    if train:
        if k_gen is None or k_gen.device.type != "cpu":
            raise ValueError("train mode draws k from k_gen, a CPU torch.Generator")
        scores = tile_scores(cfg, params, x, train=True, gen=gen)
        i = int(torch.randint(len(cfg.ks), (), generator=k_gen))
        return topk_masked_mean(scores, mask, cfg.ks[i])
    scores = tile_scores(cfg, params, x)
    vals = _top(_masked_scores(scores, mask), max(cfg.ks))[0]
    pred = torch.zeros(scores.shape[::2], dtype=scores.dtype, device=scores.device)
    for k in cfg.ks:
        pred = pred + _masked_mean(vals[..., :k], mask, int(k)) / len(cfg.ks)
    return pred


def slice_head(cfg: HE2RNAConfig, params: Params, indices) -> tuple[HE2RNAConfig, Params]:
    """Restrict the final 1x1 conv to a gene panel: the top-k masked mean is
    per gene, so selecting outputs commutes with the eval forward."""
    new = {"w": list(params["w"]), "b": list(params["b"])}
    new["w"][-1], new["b"][-1], n = slice_linear_outputs(
        params["w"][-1], params["b"][-1], indices, cfg.output_dim)
    return dataclasses.replace(cfg, output_dim=n), new


def replace_head(cfg: HE2RNAConfig, params: Params, num_outputs: int,
                 gen: torch.Generator) -> tuple[HE2RNAConfig, Params]:
    """Swap the final layer for a fresh one of ``num_outputs`` drawn from
    ``gen`` (GTEx -> TCGA transfer, reference ``he2rna.py:403-409``), in the
    params' dtype on the generator's device."""
    fan_in = cfg.layers[-1] if cfg.layers else cfg.input_dim
    w, b = torch_init.linear_params(gen, fan_in, num_outputs, params["w"][-1].dtype)
    new = {"w": list(params["w"]), "b": list(params["b"])}
    new["w"][-1], new["b"][-1] = w, b
    return dataclasses.replace(cfg, output_dim=num_outputs), new
