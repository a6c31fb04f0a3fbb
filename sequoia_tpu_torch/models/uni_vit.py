"""The ViT backbones: UNI's ViT-L/16 (timm ``vit_large_patch16_224`` with
``init_values=1e-5`` LayerScale, ``num_classes=0``) and Virchow2's ViT-H/14
(timm ``vit_huge_patch14_224`` with ``reg_tokens=4``,
``mlp_layer=SwiGLUPacked``, ``act_layer=SiLU``; Zimmermann et al.,
arXiv:2408.00738), one config-driven model.

UNI is the counterpart of ``sequoia_tpu/models/uni_vit.py``, with the same
stacked parameter layout (block parameters on a leading ``depth`` axis,
weights in ``(in, out)`` math layout), so a JAX parameter tree carries
across with ``models.convert.uni_params_from_numpy`` and a timm state dict
with :func:`uni_from_torch`.  Virchow2 has no JAX counterpart; its timm
state dict loads with :func:`virchow2_from_torch` into the same layout.

UNI: a 224x224 ImageNet-normalized patch -> the 1024-d final-norm CLS token:
the patch embed as a reshape + GEMM over (p_row, p_col, channel) token
order, the CLS token and position embedding over 197 tokens, 24 pre-norm
blocks of MHA (qkv bias, 16 heads) and MLP (4096, exact GELU), each branch
scaled by its LayerScale gamma, a final LayerNorm.  LayerNorm uses eps 1e-5,
as the JAX package does (timm's ``VisionTransformer`` uses 1e-6).

Virchow2 (:class:`Virchow2Config`): the same block at 1280 wide, 32 deep, 16
heads of 80, with four register tokens after the CLS token (the position
embedding covers all 261 tokens, timm's ``no_embed_class=False``), a packed
SwiGLU MLP (fc1 to 6832, ``silu(first half) * second half``, fc2 from 3416),
LayerNorm eps 1e-6, the final LayerNorm over every token, and the 2560-d
output CLS ⊕ the mean of the 256 patch tokens (the registers left out).
Its preprocessing is the model card's: Pillow BICUBIC ``Resize(224)`` of
the uint8 patch, then the ImageNet normalisation.

Precision.  f32 is the parity path: every product in IEEE f32 (TF32 off,
``ops/nn.precision``).  In bf16 every GEMM takes bf16 operands on the tensor
cores with f32 accumulation and one rounding of its output, bias included
(``torch.addmm``; cuBLAS is told not to reduce in bf16).  The attention
(``ops/cuda_vit.attention``, from the qkv GEMM's output to proj's input):
scores from bf16 products summed in f32, scaled in f32, a softmax over each
whole row in f32, probabilities rounded to bf16 for the product with V, as
the JAX einsums do; on the card in bf16 one hand-written kernel
(``csrc/vit_attention.cu``, ``vit_attention``) does all of it, for dh 64 or
80 and up to 512 tokens; on the CPU, in f32 and at other shapes its plain
twin runs, the same mathematics as separate PyTorch ops.  LayerNorm
statistics are f32 (``F.layer_norm`` accumulates in
f32); the residual stream, the LayerScale products and the GELU are bf16
tensors, and the output leaves as f32.  The SwiGLU gate takes two roundings
to bf16: ``silu(a)`` (computed in f32 inside the op) and its product with
``b``.  Each LayerScale residual ``x + out * gamma`` (``torch.addcmul``'s
f32 op-math, one rounding) feeds the LayerNorm after it: the attention's
LN2, the MLP's the next block's LN1, the last block's the final norm over
every token (UNI's pool then reads the CLS row alone).  On the card in
bf16 each such pair is one kernel, ``vit_residual_ln``, and the gate one
pass, ``vit_swiglu`` (``csrc/vit_glue.cu``, ``ops/cuda_vit_glue``); on the
CPU, in f32 and at other shapes their plain twins run the ops above.  The
first block's LN1, after the position embedding, stays ``F.layer_norm``.
Virchow2's patch mean is taken in f32 over the bf16 normalised
tokens.  :func:`prepare` casts the GEMM weights, biases, LayerNorm affines,
gammas and embeddings to the compute type once, so no forward casts them
again.  The JAX package computes the attention with XLA einsums, not a
Pallas kernel: the port's kernel replaces none.

Spans (``utils/profiling``, recorded only under a profiler):
``vit.preprocess`` around the resize and normalisation of
:func:`extract_from_uint8`, ``vit.attn`` around each block's attention
(after the qkv GEMM, before proj), ``vit.mlp`` around each block's MLP
branch: fc1, the GELU or gate, fc2 and the MLP's residual with the
LayerNorm after it.  LN2 runs with the attention's residual, just before
``vit.mlp``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from sequoia_tpu_torch.models.resnet import IMAGENET_MEAN, IMAGENET_STD
from sequoia_tpu_torch.ops import cuda_vit, cuda_vit_glue, pil_resize
from sequoia_tpu_torch.ops.nn import LN_EPS, compute_dtype, linear
from sequoia_tpu_torch.utils.profiling import count, span

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
    mlp_dim: int = 4096  # fc1's width
    compute_dtype: Any = torch.float32
    reg_tokens: int = 0  # register tokens after the CLS token
    mlp: str = "gelu"  # or "swiglu_packed": silu(fc1's first half) * its second half
    ln_eps: float = LN_EPS
    pool: str = "cls"  # or "cls_mean": CLS ⊕ the mean of the patch tokens
    resize: str = "bilinear"  # Pillow's filter to img_size (``ops/pil_resize``)

    def __post_init__(self):
        if self.mlp not in ("gelu", "swiglu_packed"):
            raise ValueError(f"mlp must be 'gelu' or 'swiglu_packed', got {self.mlp!r}")
        if self.pool not in ("cls", "cls_mean"):
            raise ValueError(f"pool must be 'cls' or 'cls_mean', got {self.pool!r}")
        if self.mlp == "swiglu_packed" and self.mlp_dim % 2:
            raise ValueError(f"a packed SwiGLU needs an even mlp_dim, got {self.mlp_dim}")

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def prefix(self) -> int:
        """The tokens before the patches: the CLS token and the registers."""
        return 1 + self.reg_tokens

    @property
    def tokens(self) -> int:
        return self.grid * self.grid + self.prefix

    @property
    def dim_head(self) -> int:
        return self.dim // self.heads

    @property
    def hidden_dim(self) -> int:
        """fc2's input width: half of fc1's for the packed SwiGLU."""
        return self.mlp_dim // 2 if self.mlp == "swiglu_packed" else self.mlp_dim

    @property
    def feature_dim(self) -> int:
        return 2 * self.dim if self.pool == "cls_mean" else self.dim


@dataclasses.dataclass(frozen=True)
class Virchow2Config(UniViTConfig):
    """Virchow2's ViT-H/14 (the module's docstring)."""

    patch_size: int = 14
    dim: int = 1280
    depth: int = 32
    heads: int = 16
    mlp_dim: int = 6832
    reg_tokens: int = 4
    mlp: str = "swiglu_packed"
    ln_eps: float = 1e-6
    pool: str = "cls_mean"
    resize: str = "bicubic"


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


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """LayerNorm over the last axis (biased variance), statistics in f32,
    output in ``x``'s type."""
    return F.layer_norm(x, (x.shape[-1],), scale.to(x.dtype), bias.to(x.dtype), eps)


def _swiglu(h: torch.Tensor) -> torch.Tensor:
    """timm's ``GluMlp(gate_last=False)`` gate: ``silu(a) * b`` of fc1's
    halves ``a, b`` (``ops/cuda_vit_glue.swiglu``)."""
    return cuda_vit_glue.swiglu(h)


def _residual(x: torch.Tensor, out: torch.Tensor, gamma: torch.Tensor, ln,
              eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The LayerScale residual ``x + out * gamma`` and the LayerNorm after it,
    ``ln = (scale, bias)``, as one pass (``ops/cuda_vit_glue.residual_ln``)."""
    # the LayerScale gammas in the activation's type, as JAX casts them down
    return cuda_vit_glue.residual_ln(x, out, gamma.to(out.dtype), ln[0].to(x.dtype),
                                     ln[1].to(x.dtype), eps)


def _block(cfg: UniViTConfig, x: torch.Tensor, y: torch.Tensor, bp: dict,
           ln_next) -> tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block from the residual stream ``x`` and its LN1 ``y``:
    the new stream and its LayerNorm by ``ln_next = (scale, bias)`` (the next
    block's LN1 or the final norm)."""
    b, n, d = x.shape
    qkv = _linear(y, bp["w_qkv"], bp["b_qkv"]).reshape(b * n, 3 * d)
    with span("vit.attn"):
        out = cuda_vit.attention(qkv, b, n, cfg.heads)
    out = _linear(out.reshape(b, n, d), bp["w_proj"], bp["b_proj"])
    x, y = _residual(x, out, bp["ls1"], (bp["ln2_scale"], bp["ln2_bias"]), cfg.ln_eps)

    with span("vit.mlp"):
        y = _linear(y, bp["w_fc1"], bp["b_fc1"])
        y = F.gelu(y) if cfg.mlp == "gelu" else _swiglu(y)
        y = _linear(y, bp["w_fc2"], bp["b_fc2"])
        return _residual(x, y, bp["ls2"], ln_next, cfg.ln_eps)


def forward(cfg: UniViTConfig, params: Params, images: torch.Tensor) -> torch.Tensor:
    """(B, img, img, 3) normalized NHWC float -> (B, ``cfg.feature_dim``) f32:
    the CLS embedding (UNI), or CLS ⊕ the patch tokens' mean (Virchow2)."""
    b = images.shape[0]
    p, g = cfg.patch_size, cfg.grid
    dt = compute_dtype(cfg.compute_dtype)
    x = images.to(dt)
    # conv patch embed as reshape + GEMM: (B, g, p, g, p, 3) -> (B, g*g, p*p*3)
    x = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
    x = _linear(x, params["patch_w"], params["patch_b"])  # (B, g*g, D)

    prefix = [params["cls_token"].to(dt).expand(b, 1, cfg.dim)]
    if cfg.reg_tokens:
        prefix.append(params["reg_token"].to(dt).expand(b, cfg.reg_tokens, cfg.dim))
    x = torch.cat([*prefix, x], dim=1) + params["pos_emb"].to(dt)
    blocks = params["blocks"]
    # each block's last residual carries the LayerNorm after it: the next
    # block's LN1, the last block's the final norm
    lns = [(blocks["ln1_scale"][i], blocks["ln1_bias"][i]) for i in range(1, cfg.depth)]
    lns.append((params["norm_scale"], params["norm_bias"]))
    y = _layer_norm(x, blocks["ln1_scale"][0], blocks["ln1_bias"][0], cfg.ln_eps)
    for i in range(cfg.depth):
        x, y = _block(cfg, x, y, {k: v[i] for k, v in blocks.items()}, lns[i])
    return _pool(cfg, y)


def _pool(cfg: UniViTConfig, y: torch.Tensor) -> torch.Tensor:
    """The output, in f32, from the final LayerNorm ``y`` of every token:
    the CLS row (``"cls"``), or CLS ⊕ the mean of the patch tokens,
    registers left out (``"cls_mean"``)."""
    if cfg.pool == "cls":
        return y[:, 0].float()
    y = y.float()
    return torch.cat([y[:, 0], y[:, cfg.prefix:].mean(1)], dim=-1)


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
        cfg = UniViTConfig(**_timm_shape(sd, heads, 1024, "the UNI backbone"))
    return cfg, _from_timm(sd, cfg)


def virchow2_from_torch(sd, cfg: Virchow2Config | None = None, *,
                        heads: int | None = None) -> tuple[Virchow2Config, Params]:
    """timm ``vit_huge_patch14_224`` state dict of Virchow2 (``reg_token``
    (1, 4, D), a packed ``mlp.fc1`` of (6832, D), ``mlp.fc2`` of (D, 3416))
    -> (cfg, params), f32 on the CPU, in :func:`uni_from_torch`'s layout
    plus ``reg_token`` (R, D).  The head count is inferred as 16 only at
    dim 1280; any other width must pass ``cfg`` or ``heads``."""
    if cfg is None:
        cfg = Virchow2Config(**_timm_shape(sd, heads, 1280, "Virchow2"))
    params = _from_timm(sd, cfg)
    params["reg_token"] = torch.as_tensor(
        np.ascontiguousarray(_np(sd["reg_token"]).reshape(cfg.reg_tokens, cfg.dim)))
    return cfg, params


def _timm_shape(sd, heads: int | None, known_dim: int, known: str) -> dict:
    """The config sizes a timm ViT state dict records; the head count from
    ``heads``, or 16 at ``known_dim``."""
    d = _np(sd["cls_token"]).shape[-1]
    if heads is None:
        if d != known_dim:
            raise ValueError(
                f"cannot infer the head count for dim={d} (a fused-qkv state dict does "
                f"not record it; {known} has dim {known_dim}); pass cfg= or heads=")
        heads = 16
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    mlp = _np(sd["blocks.0.mlp.fc1.weight"]).shape[0]
    p = _np(sd["patch_embed.proj.weight"]).shape[-1]
    reg = _np(sd["reg_token"]).shape[1] if "reg_token" in sd else 0
    n_tok = _np(sd["pos_embed"]).shape[1]
    img = int(round(((n_tok - 1 - reg) ** 0.5))) * p
    return dict(img_size=img, patch_size=p, dim=d, depth=depth, heads=heads, mlp_dim=mlp,
                reg_tokens=reg)


def _from_timm(sd, cfg: UniViTConfig) -> Params:
    """A timm ViT state dict's shared leaves in the port's layout."""
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

    return {
        "patch_w": t(patch_w),
        "patch_b": t(_np(sd["patch_embed.proj.bias"])),
        "cls_token": t(_np(sd["cls_token"]).reshape(1, cfg.dim)),
        "pos_emb": t(_np(sd["pos_embed"]).reshape(cfg.tokens, cfg.dim)),
        "blocks": blocks,
        "norm_scale": t(_np(sd["norm.weight"])),
        "norm_bias": t(_np(sd["norm.bias"])),
    }


def random_params(cfg: UniViTConfig, gen: torch.Generator,
                  layer_scale: float = 1e-5) -> Params:
    """Random weights at ``cfg``'s architecture (tests, benches), f32 on the
    generator's device; the JAX function's distributions, not its numbers
    (the register tokens, where there are any, drawn last, normal at 0.02
    as the CLS token).
    ``layer_scale`` fills the LayerScale gammas (timm's ``init_values``,
    1e-5 as in JAX); at 1e-5 a random block moves the residual stream by
    less than one bf16 ulp, so a bf16 forward gives every image nearly the
    same features."""
    d, mlp, hid, depth = cfg.dim, cfg.mlp_dim, cfg.hidden_dim, cfg.depth
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
        "w_fc2": nrm((depth, hid, d), hid ** -0.5),
        "b_fc2": full((depth, d), 0.0),
        "ls2": full((depth, d), layer_scale),
    }
    params = {
        "patch_w": nrm((pdim, d), pdim ** -0.5),
        "patch_b": full((d,), 0.0),
        "cls_token": nrm((1, d), 0.02),
        "pos_emb": nrm((cfg.tokens, d), 0.02),
        "blocks": blocks,
        "norm_scale": full((d,), 1.0),
        "norm_bias": full((d,), 0.0),
    }
    if cfg.reg_tokens:
        params["reg_token"] = nrm((cfg.reg_tokens, d), 0.02)
    return params


def extract_from_uint8(cfg: UniViTConfig, params: Params, u8: torch.Tensor) -> torch.Tensor:
    """uint8 patches (B, H, W, 3) -> (B, ``cfg.feature_dim``) f32 features
    with the reference preprocessing (``compute_features_hdf5.py:53-56``
    order: PIL Resize(224) on the uint8 image with ``cfg.resize``'s filter,
    bilinear for UNI and bicubic for Virchow2, bit-exact here in integers,
    then ToTensor + Normalize), the span ``vit.preprocess``.  The one
    implementation shared by the extractor and the slide program, so
    preprocessing cannot drift."""
    with span("vit.preprocess"):
        if u8.shape[1] != cfg.img_size or u8.shape[2] != cfg.img_size:
            u8 = pil_resize.resize_u8(u8, cfg.img_size, cfg.img_size, cfg.resize)
        x = u8.float() / 255.0
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
        count("host_syncs", 2)  # a list to the device is a blocking copy
        x = (x - mean) / std
    return forward(cfg, params, x)
