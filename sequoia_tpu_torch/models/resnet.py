"""ResNet feature extractor: ``(B, H, W, C)`` normalized patches ->
``(B, feature_dim)`` features, as the reference's ``forward_extract``.

Counterpart of ``sequoia_tpu/models/resnet.py``.  Same public layout
(``forward_extract`` takes channels-last images), same config fields, eval-BN
folded at load time into ``{"scale", "bias"}`` per channel.  Inside, the
port works in PyTorch's NCHW with OIHW conv weights.  The reference's
``AvgPool2d(7)`` is kept exactly: fixed 7x7 windows at stride ``pool_stride``
(on the 8x8 layer4 map of a 256-px patch only the top-left 7x7 window),
flattened channel-major, and a global mean below 7x7.

The kernel options keep their JAX names and their JAX precedence, stage by
stage: ``early_pallas`` takes stem + maxpool + layer1 through K2 ``stem16``
and K3 ``bottleneck_chain_cp``; then a stage in ``fused_stages`` runs its
stride-1 blocks through K4 ``bottleneck_chain`` in the (P, C) layout; then a
stage in ``cp_stages`` runs them through K3 in the (C, P) layout; else the
plain block loop (``ops/cuda_resnet.py``).  The stride-2 transition blocks
and every block outside those stages run as ``F.conv2d``, with TF32 off
(``ops.nn.precision``), as the JAX package leaves them to XLA.  With
``fused_stages`` the backbone runs in ``torch.channels_last``, so K4's
``(B, H*W, C)`` view of a stage is a view, not a transpose; a stage of
``cp_stages`` or ``early_pallas`` wants NCHW and pays one copy where the two
layouts meet.  :func:`forward_stages` is the forward one stage at a time
(``forward_extract`` runs it; ``tools/profile_backbone.py`` times each
stage), and the chain-weight folds are named on a ``torch.profiler`` trace
by :data:`FOLD_SPAN`.

Also here: basic blocks (resnet18/34), ``config_for_depth``, the 4- and
1-channel variants (reference ``RNfour``/``RNone``, ``pool_stride=1``) and
the ``ResNetProject`` head (``sequoia_tpu/models/resnet.py:104-148,
437-505``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from sequoia_tpu_torch.ops import cuda_resnet
from sequoia_tpu_torch.ops.nn import compute_dtype as _dtype
from sequoia_tpu_torch.utils import torch_init

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

BLOCKS_PER_STAGE = (3, 4, 6, 3)  # resnet50
STAGE_WIDTH = (64, 128, 256, 512)
EXPANSION = 4
BN_EPS = 1e-5
#: the range that names the chain-weight fold and cast (done on every
#: forward) on a ``torch.profiler`` trace
FOLD_SPAN = "resnet.chain_weight_fold"

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """``block='bottleneck'`` covers resnet50/101/152; ``'basic'`` covers
    resnet18/34.  ``early_pallas`` switches the K2/K3 CUDA kernels on for
    stem + maxpool + layer1; ``fused_stages`` (1-based) runs those stages'
    stride-1 blocks through K4, ``cp_stages`` through K3; ``pool_stride`` is
    the AvgPool2d(7) stride (1 for the reference's RNfour/RNone
    variants)."""

    compute_dtype: Any = torch.float32
    blocks_per_stage: tuple[int, ...] = BLOCKS_PER_STAGE
    block: str = "bottleneck"
    fused_stages: tuple[int, ...] = ()
    early_pallas: bool = False
    cp_stages: tuple[int, ...] = ()
    pool_stride: int = 7

    @property
    def expansion(self) -> int:
        return EXPANSION if self.block == "bottleneck" else 1

    @property
    def feature_dim(self) -> int:
        return STAGE_WIDTH[-1] * self.expansion

    def feature_dim_for(self, img_h: int, img_w: int) -> int:
        """Width of ``forward_extract``'s output for an input size (the
        reference's AvgPool2d(7) + flatten gives C*nh*nw)."""
        h, w = img_h, img_w
        for _ in range(5):  # stem conv s2, maxpool s2, layers 2-4 s2
            h, w = (h + 1) // 2, (w + 1) // 2
        if h >= 7 and w >= 7:
            s = self.pool_stride
            return self.feature_dim * (((h - 7) // s + 1) * ((w - 7) // s + 1))
        return self.feature_dim


DEPTH_TO_STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                   101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def config_for_depth(depth: int, compute_dtype=torch.float32) -> ResNetConfig:
    """resnet{18,34,50,101,152} configs (reference resnet.py constructors)."""
    return ResNetConfig(compute_dtype=compute_dtype,
                        blocks_per_stage=DEPTH_TO_STAGES[depth],
                        block="basic" if depth in (18, 34) else "bottleneck")


def _conv(x, w, stride=1):
    """NCHW conv with OIHW weights, torch padding k//2."""
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=w.shape[-1] // 2)


def _bn(x, p):
    dt = x.dtype
    return x * p["scale"].to(dt)[:, None, None] + p["bias"].to(dt)[:, None, None]


def _bottleneck(x, p, stride):
    y = torch.relu(_bn(_conv(x, p["conv1"]), p["bn1"]))
    y = torch.relu(_bn(_conv(y, p["conv2"], stride), p["bn2"]))
    y = _bn(_conv(y, p["conv3"]), p["bn3"])
    if "downsample_conv" in p:
        x = _bn(_conv(x, p["downsample_conv"], stride), p["downsample_bn"])
    return torch.relu(y + x)


def _basic_block(x, p, stride):
    """torchvision BasicBlock (resnet18/34): two 3x3 convs, expansion 1."""
    y = torch.relu(_bn(_conv(x, p["conv1"], stride), p["bn1"]))
    y = _bn(_conv(y, p["conv2"]), p["bn2"])
    if "downsample_conv" in p:
        x = _bn(_conv(x, p["downsample_conv"], stride), p["downsample_bn"])
    return torch.relu(y + x)


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 4C, H/2, W/2) NCHW, channel order (di, dj, c)."""
    b, h, w, c = x.shape
    xs = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 2, 4, 5, 1, 3)
    return xs.reshape(b, 4 * c, h // 2, w // 2)


def stem_space_to_depth(x: torch.Tensor, w_s2d: torch.Tensor) -> torch.Tensor:
    """7x7/s2 stem as space-to-depth(2) + 4x4/s1 conv (exact: the 7x7 kernel
    zero-padded to 8x8 at its leading taps).  x (B, H, W, 3), H and W even;
    w_s2d (64, 12, 4, 4) from :func:`fold_stem_to_s2d`; returns
    (B, H/2, W/2, 64)."""
    xs = F.pad(_space_to_depth(x), (2, 1, 2, 1))
    return F.conv2d(xs, w_s2d.to(xs.dtype)).permute(0, 2, 3, 1)


def fold_stem_to_s2d(conv1: torch.Tensor) -> torch.Tensor:
    """(64, 3, 7, 7) OIHW stem kernel -> (64, 12, 4, 4) space-to-depth kernel."""
    w8 = F.pad(conv1, (1, 0, 1, 0))  # zero leading taps -> (O, C, 8, 8)
    o, c = w8.shape[:2]
    w = w8.reshape(o, c, 4, 2, 4, 2)            # (o, c, bi, di, bj, dj)
    return w.permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 4, 4).contiguous()


def _early_pallas(params: Params, x: torch.Tensor) -> torch.Tensor:
    """stem + maxpool + layer1 through the (C, P) kernels; NHWC in, NCHW out."""
    b, h, w, _ = x.shape
    h2, w2 = h // 2, w // 2
    # s2d channels (di, dj, c), padded to 16 channels, 2 zero rows on top and
    # 1 below, so the kernel's four dy taps are whole-row offsets
    x16 = F.pad(_space_to_depth(x), (0, 0, 2, 1, 0, 4))
    with record_function(FOLD_SPAN):
        a, bias = cuda_resnet.fold_stem16_weights(params["conv1_s2d"], params["bn1"], x.dtype)
    y = cuda_resnet.stem16(x16.reshape(b, 16, (h2 + 3) * w2), a, bias, H2=h2, W2=w2)
    y = F.max_pool2d(y.reshape(b, 64, h2, w2), 3, 2, 1)  # torch maxpool, NCHW
    hp, wp = y.shape[2], y.shape[3]
    with record_function(FOLD_SPAN):
        flat, meta = cuda_resnet.stage_chain_weights_cp(params["layer1"], 0, y.dtype)
    out = cuda_resnet.bottleneck_chain_cp(y.reshape(b, 64, hp * wp), flat, meta=meta,
                                          H=hp, W=wp)
    return out.reshape(b, meta[-1][2], hp, wp)


def forward_stages(cfg: ResNetConfig, params: Params,
                   images: torch.Tensor) -> Iterator[tuple[str, torch.Tensor]]:
    """:func:`forward_extract` one stage at a time: yields ``(name,
    activation)`` after the stem (conv + BN + ReLU, NCHW), the max pool, each
    of ``layer1``-``layer4`` and the pooled ``mean`` (the features).  Under
    ``early_pallas`` the stem, pool and layer1 are one step,
    ``"stem+pool+layer1"`` (K2, the max pool, K3)."""
    x = images.to(_dtype(cfg.compute_dtype))
    layout = torch.channels_last if cfg.fused_stages else torch.contiguous_format
    start_stage = 0
    if (cfg.early_pallas and cfg.block == "bottleneck" and x.shape[3] == 3
            and "conv1_s2d" in params and x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0):
        x = _early_pallas(params, x)
        start_stage = 1
        yield "stem+pool+layer1", x
    else:
        if "conv1_s2d" in params and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
            x = stem_space_to_depth(x, params["conv1_s2d"]).permute(0, 3, 1, 2)
        else:
            x = _conv(x.permute(0, 3, 1, 2), params["conv1"], stride=2)
        x = torch.relu(_bn(x, params["bn1"]))
        yield "stem", x
        x = F.max_pool2d(x, 3, 2, 1)
        yield "pool", x
    x = x.contiguous(memory_format=layout)
    block_fn = _bottleneck if cfg.block == "bottleneck" else _basic_block
    for s in range(start_stage, len(cfg.blocks_per_stage)):
        blocks = params[f"layer{s + 1}"]
        start = 0
        if s > 0:  # the stride-2 transition block stays F.conv2d
            x = block_fn(x, blocks[0], 2)
            start = 1
        chain = cfg.block == "bottleneck" and len(blocks) > start
        if chain and (s + 1) in cfg.fused_stages:
            x = _fused_chain(x, blocks, start)
        elif chain and (s + 1) in cfg.cp_stages:
            x = _fused_chain_cp(x, blocks, start).contiguous(memory_format=layout)
        else:
            for blk in blocks[start:]:
                x = block_fn(x, blk, 1)
        yield f"layer{s + 1}", x
    x = x.float()
    if x.shape[2] >= 7 and x.shape[3] >= 7:
        # AvgPool2d(7) with fixed windows, flattened channel-major
        yield "mean", F.avg_pool2d(x, 7, stride=cfg.pool_stride).reshape(x.shape[0], -1)
    else:
        yield "mean", x.mean((2, 3))  # maps below 7x7: global mean (small test inputs)


def forward_extract(cfg: ResNetConfig, params: Params, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) normalized float -> (B, feature_dim_for(H, W)) f32."""
    for _, x in forward_stages(cfg, params, images):
        pass
    return x


def _fused_chain(x: torch.Tensor, blocks, start: int) -> torch.Tensor:
    """Run blocks[start:] (all stride 1) through K4 in the (P, C) layout.
    The JAX row-chunk rule is kept: whole rows, at most 512 pixels for bf16
    and 256 for f32."""
    b, c, h, w = x.shape
    with record_function(FOLD_SPAN):
        flat, meta = cuda_resnet.stage_chain_weights(blocks, start, x.dtype)
    target = 512 if x.dtype == torch.bfloat16 else 256
    rows = min(h, max(1, target // w))
    while (h * w) % (w * rows):
        rows -= 1
    # a view for a channels_last x: (B, H, W, C) is its storage order
    out = cuda_resnet.bottleneck_chain(x.permute(0, 2, 3, 1).reshape(b, h * w, c), flat,
                                       meta=meta, H=h, W=w, row_chunk=w * rows)
    return out.reshape(b, h, w, meta[-1][2]).permute(0, 3, 1, 2)


def _fused_chain_cp(x: torch.Tensor, blocks, start: int) -> torch.Tensor:
    """Run blocks[start:] (all stride 1) through K3 in the (C, P) layout."""
    b, c, h, w = x.shape
    with record_function(FOLD_SPAN):
        flat, meta = cuda_resnet.stage_chain_weights_cp(blocks, start, x.dtype)
    out = cuda_resnet.bottleneck_chain_cp(x.reshape(b, c, h * w), flat, meta=meta, H=h, W=w)
    return out.reshape(b, meta[-1][2], h, w)


def preprocess_uint8(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> ImageNet-normalized f32."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def extract_from_uint8(cfg: ResNetConfig, params: Params,
                       images_u8: torch.Tensor) -> torch.Tensor:
    return forward_extract(cfg, params, preprocess_uint8(images_u8))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _fold_bn(sd, prefix) -> dict[str, torch.Tensor]:
    gamma, beta = _np(sd[prefix + ".weight"]), _np(sd[prefix + ".bias"])
    mean, var = _np(sd[prefix + ".running_mean"]), _np(sd[prefix + ".running_var"])
    scale = gamma / np.sqrt(var + BN_EPS)
    return {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(beta - mean * scale)}


def enable_s2d_stem(params: Params) -> Params:
    """Attach the space-to-depth stem kernel (``conv1`` stays for the
    general path)."""
    if tuple(params["conv1"].shape[2:]) == (7, 7):
        params = dict(params)
        params["conv1_s2d"] = fold_stem_to_s2d(params["conv1"])
    return params


def resnet_from_torch(sd) -> tuple[ResNetConfig, Params]:
    """torchvision ResNet state dict (any depth) -> (config, params), eval BN
    folded, f32 on the CPU."""
    def conv(name):
        return torch.from_numpy(_np(sd[name]).copy())

    params: Params = {"conv1": conv("conv1.weight"), "bn1": _fold_bn(sd, "bn1")}
    blocks_per_stage = []
    has_conv3 = "layer1.0.conv3.weight" in sd
    for s in range(4):
        layer = []
        while f"layer{s + 1}.{len(layer)}.conv1.weight" in sd:
            pre = f"layer{s + 1}.{len(layer)}."
            blk = {"conv1": conv(pre + "conv1.weight"), "bn1": _fold_bn(sd, pre + "bn1"),
                   "conv2": conv(pre + "conv2.weight"), "bn2": _fold_bn(sd, pre + "bn2")}
            if has_conv3:
                blk["conv3"] = conv(pre + "conv3.weight")
                blk["bn3"] = _fold_bn(sd, pre + "bn3")
            if pre + "downsample.0.weight" in sd:
                blk["downsample_conv"] = conv(pre + "downsample.0.weight")
                blk["downsample_bn"] = _fold_bn(sd, pre + "downsample.1")
            layer.append(blk)
        blocks_per_stage.append(len(layer))
        params[f"layer{s + 1}"] = layer
    cfg = ResNetConfig(blocks_per_stage=tuple(blocks_per_stage),
                       block="bottleneck" if has_conv3 else "basic")
    return cfg, enable_s2d_stem(params)


def resnet50_from_torch(sd) -> Params:
    return resnet_from_torch(sd)[1]


def random_params(gen: torch.Generator, dtype=torch.float32) -> Params:
    """He-normal random ResNet-50 weights (identity BN) on the generator's
    device, for tests and benchmarks without the torchvision download."""
    dev = gen.device

    def conv(cout, cin, k):
        w = torch.randn((cout, cin, k, k), generator=gen, dtype=dtype, device=dev)
        return w * float(np.sqrt(2.0 / (k * k * cin)))

    def bn(c):
        return {"scale": torch.ones(c, dtype=dtype, device=dev),
                "bias": torch.zeros(c, dtype=dtype, device=dev)}

    params: Params = {"conv1": conv(64, 3, 7), "bn1": bn(64)}
    cin = 64
    for s, nblocks in enumerate(BLOCKS_PER_STAGE):
        width, layer = STAGE_WIDTH[s], []
        cout = width * EXPANSION
        for b in range(nblocks):
            blk = {"conv1": conv(width, cin, 1), "bn1": bn(width),
                   "conv2": conv(width, width, 3), "bn2": bn(width),
                   "conv3": conv(cout, width, 1), "bn3": bn(cout)}
            if b == 0:
                blk["downsample_conv"] = conv(cout, cin, 1)
                blk["downsample_bn"] = bn(cout)
            layer.append(blk)
            cin = cout
        params[f"layer{s + 1}"] = layer
    return enable_s2d_stem(params)


# ---------------------------------------------------------------------------
# Variants (reference src/resnet.py RNfour / RNone / ResNetProject: not used by
# the main pipeline, part of the API surface)
# ---------------------------------------------------------------------------

def random_params_channels(gen: torch.Generator, in_channels: int,
                           dtype=torch.float32) -> Params:
    """ResNet-50 with a non-RGB stem (4-channel fluorescence / 1-channel
    grayscale variants); the space-to-depth stem is rebuilt for it."""
    params = random_params(gen, dtype)
    cout, _, kh, kw = params["conv1"].shape
    w = torch.randn((cout, in_channels, kh, kw), generator=gen, dtype=dtype, device=gen.device)
    params["conv1"] = w * float(np.sqrt(2.0 / (kh * kw * in_channels)))
    params.pop("conv1_s2d", None)
    return enable_s2d_stem(params)


def resnet50_4channel(gen: torch.Generator | None = None, sd=None) -> Params:
    """4-channel-input ResNet-50 (reference ``RNfour``).  Run with
    ``ResNetConfig(pool_stride=1)``: RNfour pools ``AvgPool2d(7, stride=1)``."""
    if sd is not None:
        return resnet50_from_torch(sd)
    return random_params_channels(gen, 4)


def resnet50_1channel(gen: torch.Generator | None = None, sd=None) -> Params:
    """1-channel-input ResNet-50 (reference ``RNone``).  Run with
    ``ResNetConfig(pool_stride=1)``."""
    if sd is not None:
        return resnet50_from_torch(sd)
    return random_params_channels(gen, 1)


@dataclasses.dataclass(frozen=True)
class ResNetProjectConfig:
    """Reference ``ResNetProject``: backbone embedding -> Linear(hdim) ->
    tanh -> dropout -> Linear(1)."""

    hdim: int = 200
    input_dim: int = 2048
    dropout: float = 0.3
    compute_dtype: Any = torch.float32


def resnet_project_init(cfg: ResNetProjectConfig, gen: torch.Generator) -> Params:
    pw, pb = torch_init.linear_params(gen, cfg.input_dim, cfg.hdim)
    fw, fb = torch_init.linear_params(gen, cfg.hdim, 1)
    return {"project_w": pw, "project_b": pb, "fc_w": fw, "fc_b": fb}


def resnet_project_extract(cfg: ResNetProjectConfig, proj_params: Params,
                           backbone_params: Params, images: torch.Tensor, *,
                           train: bool = False, gen: torch.Generator | None = None
                           ) -> torch.Tensor:
    """Backbone features -> tanh(Linear(hdim)), dropout (from ``gen``) when
    training."""
    feats = forward_extract(ResNetConfig(cfg.compute_dtype), backbone_params, images)
    x = torch.tanh(feats @ proj_params["project_w"] + proj_params["project_b"])
    if train and cfg.dropout > 0:
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - cfg.dropout
        x = torch.where(keep, x / (1.0 - cfg.dropout), torch.zeros((), device=x.device))
    return x


def resnet_project_forward(cfg: ResNetProjectConfig, proj_params: Params,
                           backbone_params: Params, images: torch.Tensor, *,
                           train: bool = False, gen: torch.Generator | None = None
                           ) -> torch.Tensor:
    x = resnet_project_extract(cfg, proj_params, backbone_params, images,
                               train=train, gen=gen)
    return x @ proj_params["fc_w"] + proj_params["fc_b"]
