"""The UNI backbone as the reference pipeline runs it (timm
``vit_large_patch16_224``, ``num_classes=0``, LayerScale): Pillow's bilinear
``Resize(224)`` of each uint8 patch, the ImageNet normalisation, a 16x16
patch embedding, the CLS token and position embedding, pre-norm blocks of
multi-head attention and an exact-GELU MLP each scaled by its LayerScale
gamma, and the final LayerNorm of the CLS token.  LayerNorm takes eps 1e-5,
as the program does (timm's is 1e-6; with random weights either is a
stated choice of the configuration).

Weights: ``patch_w`` (p*p*3, D) over (row, column, channel) of a patch,
``patch_b``, ``cls_token`` (1, D), ``pos_emb`` (tokens, D), ``norm_scale``,
``norm_bias``, and ``blocks`` of tensors stacked over depth with GEMM
weights in (in, out) layout."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from benchmark.reference import numerics as nx
from benchmark.reference.resnet50 import MEAN, STD


def resize(u8: np.ndarray, size: int) -> np.ndarray:
    """(B, H, W, 3) uint8 -> (B, size, size, 3) with Pillow's BILINEAR."""
    if u8.shape[1] == size and u8.shape[2] == size:
        return u8
    return np.stack([np.asarray(Image.fromarray(p).resize((size, size), Image.BILINEAR))
                     for p in u8])


def _linear(x, w, b, mode):
    return nx.matmul(x, w, mode) + b.float()


def features(params: dict, u8: np.ndarray, *, img: int, patch: int, heads: int,
             device, mode: str = "float32") -> torch.Tensor:
    """(B, H, W, 3) uint8 on the host -> (B, D) f32 CLS features."""
    with nx.precision(mode):
        x = torch.as_tensor(resize(u8, img), device=device).float() / 255.0
        x = (x - torch.tensor(MEAN, device=device)) / torch.tensor(STD, device=device)
        b, g = x.shape[0], img // patch
        x = x.reshape(b, g, patch, g, patch, 3).permute(0, 1, 3, 2, 4, 5)
        x = _linear(x.reshape(b, g * g, patch * patch * 3), params["patch_w"],
                    params["patch_b"], mode)
        d = x.shape[-1]
        x = torch.cat([params["cls_token"].float().expand(b, 1, d), x], 1)
        x = x + params["pos_emb"].float()
        bl = params["blocks"]
        dh = d // heads
        for i in range(bl["w_qkv"].shape[0]):
            y = nx.layer_norm(x, bl["ln1_scale"][i].float(), bl["ln1_bias"][i].float())
            qkv = _linear(y, bl["w_qkv"][i], bl["b_qkv"][i], mode)
            q, k, v = qkv.reshape(b, -1, 3, heads, dh).permute(2, 0, 3, 1, 4)
            att = torch.softmax(nx.matmul(q, k.transpose(-1, -2), mode) * dh ** -0.5, -1)
            o = nx.matmul(att, v, mode).transpose(1, 2).reshape(b, -1, d)
            x = x + _linear(o, bl["w_proj"][i], bl["b_proj"][i], mode) * bl["ls1"][i].float()
            y = nx.layer_norm(x, bl["ln2_scale"][i].float(), bl["ln2_bias"][i].float())
            y = F.gelu(_linear(y, bl["w_fc1"][i], bl["b_fc1"][i], mode))
            x = x + _linear(y, bl["w_fc2"][i], bl["b_fc2"][i], mode) * bl["ls2"][i].float()
        return nx.layer_norm(x[:, 0], params["norm_scale"].float(), params["norm_bias"].float())
