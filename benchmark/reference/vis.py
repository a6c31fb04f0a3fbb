"""The ViS aggregator (SEQUOIA's SummaryMixing transformer,
gevaertlab/sequoia-pub ``src/tformer_lin.py``) as plain PyTorch:
``(B, N, D)`` cluster features -> ``(B, G)`` genes.

Per block, for each head: a local branch ``GELU(LN(x Wf + bf))``, a summary
branch ``GELU(LN(mean_tokens(x Ws + bs)))`` broadcast to every token, their
concatenation through ``GELU(. Wc + bc)``; the heads' outputs projected back
to D and added to x; then a pre-LN feed-forward (D -> D -> D, GELU) added to
x.  After the blocks: the token mean, a LayerNorm and the gene head.

Weights: ``pos_emb`` (N, D); ``blocks`` stacked over depth: ``wf``/``ws``
(D, H*df), ``bf``/``bs``, ``wc`` (H, df+ds, dc), ``bc`` (H, dc), per-head
LayerNorm affines ``ln_f_*``/``ln_s_*`` (H, df), ``wproj`` (H*dc, D),
``bproj``, ``ln_ff_*`` (D,), ``w1``/``w2`` (D, D), ``b1``/``b2``; then
``head_ln_scale``/``head_ln_bias`` and ``head_w`` (D, G), ``head_b``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import numerics as nx


def forward(params: dict, x: torch.Tensor, heads: int, mode: str = "float32") -> torch.Tensor:
    """f32 forward (autograd passes through it)."""
    with nx.precision(mode):
        x = x.float() + params["pos_emb"].float()
        bl = params["blocks"]
        b, n, d = x.shape
        for i in range(bl["wf"].shape[0]):
            f = nx.matmul(x, bl["wf"][i], mode) + bl["bf"][i]
            f = f.reshape(b, n, heads, -1)
            f = F.gelu(nx.layer_norm(f, bl["ln_f_scale"][i], bl["ln_f_bias"][i]))
            s = (nx.matmul(x, bl["ws"][i], mode) + bl["bs"][i]).reshape(b, n, heads, -1)
            s = F.gelu(nx.layer_norm(s.mean(1), bl["ln_s_scale"][i], bl["ln_s_bias"][i]))
            cat = torch.cat([f, s[:, None].expand(b, n, heads, s.shape[-1])], -1)
            c = torch.einsum("bnhi,hio->bnho", nx.quant(cat, mode), nx.quant(bl["wc"][i], mode))
            c = F.gelu(c + bl["bc"][i])
            x = x + nx.matmul(c.reshape(b, n, -1), bl["wproj"][i], mode) + bl["bproj"][i]
            y = nx.layer_norm(x, bl["ln_ff_scale"][i], bl["ln_ff_bias"][i])
            y = F.gelu(nx.matmul(y, bl["w1"][i], mode) + bl["b1"][i])
            x = x + nx.matmul(y, bl["w2"][i], mode) + bl["b2"][i]
        h = nx.layer_norm(x.mean(1), params["head_ln_scale"], params["head_ln_bias"])
        return nx.matmul(h, params["head_w"], mode) + params["head_b"]
