"""UNI backbone: ViT-L/16 (timm ``vit_large_patch16_224`` with
``init_values=1e-5`` LayerScale, ``num_classes=0``).

Counterpart of ``sequoia_tpu/models/uni_vit.py``, with the same stacked
parameter layout (block parameters on a leading ``depth`` axis, weights in
``(in, out)`` math layout), so a JAX parameter tree carries across with
``models.convert.uni_params_from_numpy`` and a timm state dict with
:func:`uni_from_torch`.

A 224x224 ImageNet-normalized patch -> the 1024-d final-norm CLS token: the
patch embed as a reshape + GEMM over (p_row, p_col, channel) token order,
the CLS token and position embedding over 197 tokens, 24 pre-norm blocks of
MHA (qkv bias, 16 heads) and MLP (4096, exact GELU), each branch scaled by
its LayerScale gamma, a final LayerNorm.  LayerNorm uses eps 1e-5, as the
JAX package does (timm's ``VisionTransformer`` uses 1e-6).

Precision.  f32 is the parity path: every product in IEEE f32 (TF32 off,
``ops/nn.precision``).  In bf16 every GEMM takes bf16 operands on the tensor
cores with f32 accumulation and one rounding of its output, bias included
(``torch.addmm``; cuBLAS is told not to reduce in bf16).  The attention
scores come out of their product in f32, the softmax runs in f32 and its
probabilities are rounded to bf16 for the product with V, as the JAX
einsums do.  LayerNorm statistics are f32 (``F.layer_norm`` accumulates in
f32); the residual stream, the LayerScale products and the GELU are bf16
tensors, and the CLS row leaves as f32.  :func:`prepare` casts the GEMM
weights, biases, LayerNorm affines, gammas and embeddings to the compute
type once, so no forward casts them again.  The attention is plain
``torch.matmul`` + softmax: the JAX package computes it with XLA einsums,
not a Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from sequoia_tpu_torch.models.resnet import IMAGENET_MEAN, IMAGENET_STD
from sequoia_tpu_torch.ops import pil_resize
from sequoia_tpu_torch.ops.nn import LN_EPS, compute_dtype, linear
from sequoia_tpu_torch.utils.profiling import count

Params = dict[str, Any]

#: the block GEMM weights, stored (in, out): transposed from torch's (out, in)
_GEMM = ("w_qkv", "w_proj", "w_fc1", "w_fc2")


@dataclasses.dataclass(frozen=True)
class UniViTConfig:
    img_size: int = 224
    patch_size: int = 16
    dim: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_dim: int = 4096
    compute_dtype: Any = torch.float32

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def tokens(self) -> int:
        return self.grid * self.grid + 1

    @property
    def dim_head(self) -> int:
        return self.dim // self.heads


def prepare(cfg: UniViTConfig, params: Params) -> Params:
    """The parameters in ``cfg.compute_dtype`` (every tensor of the tree),
    cast once; f32 leaves them as they are."""
    dt = compute_dtype(cfg.compute_dtype)
    if dt == torch.float32:
        return params
    return {k: ({kk: vv.to(dt) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dt))
            for k, v in params.items()}


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``: f32 through ``ops.nn.linear`` (IEEE f32), bf16 as one
    ``addmm`` with bf16 operands, f32 accumulation and one rounding."""
    if x.dtype == torch.float32:
        return linear(x, w, b)
    y = torch.addmm(b.to(x.dtype), x.reshape(-1, x.shape[-1]), w.to(x.dtype))
    return y.reshape(*x.shape[:-1], w.shape[1])


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis (biased variance, eps 1e-5), statistics
    in f32, output in ``x``'s type."""
    return F.layer_norm(x, (x.shape[-1],), scale.to(x.dtype), bias.to(x.dtype), LN_EPS)


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


def _block(cfg: UniViTConfig, x: torch.Tensor, bp: dict) -> torch.Tensor:
    b, n, d = x.shape
    h, dh = cfg.heads, cfg.dim_head

    y = _layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
    qkv = _linear(y, bp["w_qkv"], bp["b_qkv"]).reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.softmax(_scores(q, k, dh ** -0.5), dim=-1).to(v.dtype)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, h * dh)
    out = _linear(out, bp["w_proj"], bp["b_proj"])
    # the LayerScale gammas in the activation's type, as JAX casts them down
    x = torch.addcmul(x, out, bp["ls1"].to(out.dtype))

    y = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
    y = F.gelu(_linear(y, bp["w_fc1"], bp["b_fc1"]))
    y = _linear(y, bp["w_fc2"], bp["b_fc2"])
    return torch.addcmul(x, y, bp["ls2"].to(y.dtype))


def forward(cfg: UniViTConfig, params: Params, images: torch.Tensor) -> torch.Tensor:
    """(B, 224, 224, 3) normalized NHWC float -> (B, 1024) f32 CLS embedding."""
    b = images.shape[0]
    p, g = cfg.patch_size, cfg.grid
    dt = compute_dtype(cfg.compute_dtype)
    x = images.to(dt)
    # conv patch embed as reshape + GEMM: (B, g, p, g, p, 3) -> (B, g*g, p*p*3)
    x = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
    x = _linear(x, params["patch_w"], params["patch_b"])  # (B, N-1, D)

    cls = params["cls_token"].to(dt).expand(b, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + params["pos_emb"].to(dt)
    blocks = params["blocks"]
    for i in range(cfg.depth):
        x = _block(cfg, x, {k: v[i] for k, v in blocks.items()})
    # LayerNorm is per token: normalising the CLS row alone gives its values
    return _layer_norm(x[:, 0], params["norm_scale"], params["norm_bias"]).float()


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def uni_from_torch(sd, cfg: UniViTConfig | None = None, *,
                   heads: int | None = None) -> tuple[UniViTConfig, Params]:
    """timm ``vit_large_patch16_224`` state dict -> (cfg, params), f32 on
    the CPU.

    The conv patch-embed kernel (D, 3, p, p) is laid out again to match the
    reshape + GEMM token order (p_row, p_col, channel).

    The head count is not recoverable from a fused-qkv state dict; it is
    inferred as 16 only at the ViT-L width (dim 1024, the UNI backbone,
    reference ``compute_features_hdf5.py:62-68``).  Any other width must
    pass ``cfg`` or ``heads``."""
    if cfg is None:
        d = _np(sd["cls_token"]).shape[-1]
        if heads is None:
            if d != 1024:
                raise ValueError(
                    f"cannot infer the head count for dim={d} (a fused-qkv "
                    f"state dict does not record it); pass cfg= or heads=")
            heads = 16
        depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
        mlp = _np(sd["blocks.0.mlp.fc1.weight"]).shape[0]
        p = _np(sd["patch_embed.proj.weight"]).shape[-1]
        n_tok = _np(sd["pos_embed"]).shape[1]
        img = int(round(((n_tok - 1) ** 0.5))) * p
        cfg = UniViTConfig(img_size=img, patch_size=p, dim=d, depth=depth,
                           heads=heads, mlp_dim=mlp)

    w = _np(sd["patch_embed.proj.weight"])  # (D, 3, p, p)
    patch_w = w.transpose(2, 3, 1, 0).reshape(-1, cfg.dim)  # (p*p*3, D)

    names = {"ln1_scale": "norm1.weight", "ln1_bias": "norm1.bias",
             "w_qkv": "attn.qkv.weight", "b_qkv": "attn.qkv.bias",
             "w_proj": "attn.proj.weight", "b_proj": "attn.proj.bias", "ls1": "ls1.gamma",
             "ln2_scale": "norm2.weight", "ln2_bias": "norm2.bias",
             "w_fc1": "mlp.fc1.weight", "b_fc1": "mlp.fc1.bias",
             "w_fc2": "mlp.fc2.weight", "b_fc2": "mlp.fc2.bias", "ls2": "ls2.gamma"}
    blocks = {}
    for key, name in names.items():
        arrs = [_np(sd[f"blocks.{i}.{name}"]) for i in range(cfg.depth)]
        if key in _GEMM:  # torch (out, in) -> math layout (in, out)
            arrs = [a.T for a in arrs]
        blocks[key] = torch.as_tensor(np.ascontiguousarray(np.stack(arrs)))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a))

    params: Params = {
        "patch_w": t(patch_w),
        "patch_b": t(_np(sd["patch_embed.proj.bias"])),
        "cls_token": t(_np(sd["cls_token"]).reshape(1, cfg.dim)),
        "pos_emb": t(_np(sd["pos_embed"]).reshape(cfg.tokens, cfg.dim)),
        "blocks": blocks,
        "norm_scale": t(_np(sd["norm.weight"])),
        "norm_bias": t(_np(sd["norm.bias"])),
    }
    return cfg, params


def random_params(cfg: UniViTConfig, gen: torch.Generator,
                  layer_scale: float = 1e-5) -> Params:
    """Random weights at the UNI architecture (tests, benches), f32 on the
    generator's device; the JAX function's distributions, not its numbers.
    ``layer_scale`` fills the LayerScale gammas (timm's ``init_values``,
    1e-5 as in JAX); at 1e-5 a random block moves the residual stream by
    less than one bf16 ulp, so a bf16 forward gives every image nearly the
    same features."""
    d, mlp, depth = cfg.dim, cfg.mlp_dim, cfg.depth
    pdim = cfg.patch_size * cfg.patch_size * 3
    dev = gen.device

    def nrm(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    blocks = {
        "ln1_scale": full((depth, d), 1.0), "ln1_bias": full((depth, d), 0.0),
        "w_qkv": nrm((depth, d, 3 * d), d ** -0.5),
        "b_qkv": full((depth, 3 * d), 0.0),
        "w_proj": nrm((depth, d, d), d ** -0.5),
        "b_proj": full((depth, d), 0.0),
        "ls1": full((depth, d), layer_scale),
        "ln2_scale": full((depth, d), 1.0), "ln2_bias": full((depth, d), 0.0),
        "w_fc1": nrm((depth, d, mlp), d ** -0.5),
        "b_fc1": full((depth, mlp), 0.0),
        "w_fc2": nrm((depth, mlp, d), mlp ** -0.5),
        "b_fc2": full((depth, d), 0.0),
        "ls2": full((depth, d), layer_scale),
    }
    return {
        "patch_w": nrm((pdim, d), pdim ** -0.5),
        "patch_b": full((d,), 0.0),
        "cls_token": nrm((1, d), 0.02),
        "pos_emb": nrm((cfg.tokens, d), 0.02),
        "blocks": blocks,
        "norm_scale": full((d,), 1.0),
        "norm_bias": full((d,), 0.0),
    }


def extract_from_uint8(cfg: UniViTConfig, params: Params, u8: torch.Tensor) -> torch.Tensor:
    """uint8 patches (B, H, W, 3) -> (B, dim) f32 UNI features with the
    reference preprocessing (``compute_features_hdf5.py:53-56`` order: PIL
    Resize(224) on the uint8 image, bit-exact here in integers, then
    ToTensor + Normalize).  The one implementation shared by the extractor
    and the slide program, so preprocessing cannot drift."""
    if u8.shape[1] != cfg.img_size or u8.shape[2] != cfg.img_size:
        u8 = pil_resize.resize_u8(u8, cfg.img_size, cfg.img_size)
    x = u8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    count("host_syncs", 2)  # a list to the device is a blocking copy
    return forward(cfg, params, (x - mean) / std)
