"""The Virchow2 backbone as its model card runs it (Zimmermann et al.,
arXiv:2408.00738; timm ``vit_huge_patch14_224`` with ``reg_tokens=4``,
``mlp_layer=SwiGLUPacked``, ``act_layer=SiLU``, ``num_classes=0``):
Pillow's BICUBIC ``Resize(224)`` of each uint8 patch (the centre crop of
``crop_pct`` 1.0 does nothing), the ImageNet normalisation, a 14x14 patch
embedding, the CLS token, four register tokens and a position embedding
over all of them (timm's ``no_embed_class=False``), pre-norm blocks of
multi-head attention and a packed SwiGLU MLP (``silu(a) * b`` of fc1's two
halves, timm's ``GluMlp(gate_last=False)``) each scaled by its LayerScale
gamma, the final LayerNorm over every token, and the output CLS ⊕ the mean
of the patch tokens (the registers left out).  LayerNorm takes eps 1e-6,
as timm's ViT.

Departures from the published model: nothing is loaded (the weights are
the run's seeded ones), and the LayerScale gammas are what those weights
hold (0.1 in the configuration, against the trained model's values).

Weights: ``patch_w`` (p*p*3, D) over (row, column, channel) of a patch,
``patch_b``, ``cls_token`` (1, D), ``reg_token`` (R, D), ``pos_emb``
(tokens, D), ``norm_scale``, ``norm_bias``, and ``blocks`` of tensors
stacked over depth with GEMM weights in (in, out) layout (``w_fc1`` (D, F),
``w_fc2`` (F/2, D))."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from benchmark.reference import numerics as nx
from benchmark.reference.resnet50 import MEAN, STD

EPS = 1e-6


def resize(u8: np.ndarray, size: int) -> np.ndarray:
    """(B, H, W, 3) uint8 -> (B, size, size, 3) with Pillow's BICUBIC."""
    if u8.shape[1] == size and u8.shape[2] == size:
        return u8
    return np.stack([np.asarray(Image.fromarray(p).resize((size, size), Image.BICUBIC))
                     for p in u8])


def _linear(x, w, b, mode):
    return nx.matmul(x, w, mode) + b.float()


def features(params: dict, u8: np.ndarray, *, img: int, patch: int, heads: int,
             device, mode: str = "float32") -> torch.Tensor:
    """(B, H, W, 3) uint8 on the host -> (B, 2 D) f32: CLS ⊕ patch mean."""
    with nx.precision(mode):
        x = torch.as_tensor(resize(u8, img), device=device).float() / 255.0
        x = (x - torch.tensor(MEAN, device=device)) / torch.tensor(STD, device=device)
        b, g = x.shape[0], img // patch
        x = x.reshape(b, g, patch, g, patch, 3).permute(0, 1, 3, 2, 4, 5)
        x = _linear(x.reshape(b, g * g, patch * patch * 3), params["patch_w"],
                    params["patch_b"], mode)
        d = x.shape[-1]
        reg = params["reg_token"].float()
        prefix = 1 + reg.shape[0]
        x = torch.cat([params["cls_token"].float().expand(b, 1, d),
                       reg.expand(b, *reg.shape), x], 1)
        x = x + params["pos_emb"].float()
        bl = params["blocks"]
        dh = d // heads
        for i in range(bl["w_qkv"].shape[0]):
            y = nx.layer_norm(x, bl["ln1_scale"][i].float(), bl["ln1_bias"][i].float(), EPS)
            qkv = _linear(y, bl["w_qkv"][i], bl["b_qkv"][i], mode)
            q, k, v = qkv.reshape(b, -1, 3, heads, dh).permute(2, 0, 3, 1, 4)
            att = torch.softmax(nx.matmul(q, k.transpose(-1, -2), mode) * dh ** -0.5, -1)
            o = nx.matmul(att, v, mode).transpose(1, 2).reshape(b, -1, d)
            x = x + _linear(o, bl["w_proj"][i], bl["b_proj"][i], mode) * bl["ls1"][i].float()
            y = nx.layer_norm(x, bl["ln2_scale"][i].float(), bl["ln2_bias"][i].float(), EPS)
            a, gate = _linear(y, bl["w_fc1"][i], bl["b_fc1"][i], mode).chunk(2, -1)
            y = F.silu(a) * gate
            x = x + _linear(y, bl["w_fc2"][i], bl["b_fc2"][i], mode) * bl["ls2"][i].float()
        y = nx.layer_norm(x, params["norm_scale"].float(), params["norm_bias"].float(), EPS)
        return torch.cat([y[:, 0], y[:, prefix:].mean(1)], -1)
