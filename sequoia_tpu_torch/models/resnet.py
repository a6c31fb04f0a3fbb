"""ResNet-50 feature extractor: ``(B, H, W, 3)`` normalized patches ->
``(B, 2048)`` features, as the reference's ``forward_extract``.

Counterpart of ``sequoia_tpu/models/resnet.py:38-429``.  Same public layout
(``forward_extract`` takes channels-last images), same config fields, eval-BN
folded at load time into ``{"scale", "bias"}`` per channel.  Inside, the
port works in PyTorch's NCHW with OIHW conv weights.  The reference's
``AvgPool2d(7)`` is kept exactly: fixed 7x7 windows at stride ``pool_stride``
(on the 8x8 layer4 map of a 256-px patch only the top-left 7x7 window),
flattened channel-major, and a global mean below 7x7.

``ResNetConfig.early_pallas`` runs stem + maxpool + layer1 through the CUDA
kernels K2 ``stem16`` and K3 ``bottleneck_chain_cp`` (``ops/cuda_resnet.py``;
the flag keeps its JAX name).  The other convolutions (the stride-2
transition blocks and layers 2-4) run as ``F.conv2d``, with TF32 off
(``ops.nn.precision``), as the JAX package leaves them to XLA.
``fused_stages`` and ``cp_stages`` need kernel K4 and its stage wiring, which
are not ported yet (ROADMAP.md): they raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from sequoia_tpu_torch.ops import cuda_resnet
from sequoia_tpu_torch.ops.nn import compute_dtype as _dtype

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

BLOCKS_PER_STAGE = (3, 4, 6, 3)  # resnet50
STAGE_WIDTH = (64, 128, 256, 512)
EXPANSION = 4
BN_EPS = 1e-5

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """``block='bottleneck'`` covers resnet50/101/152 (``'basic'``,
    resnet18/34, is not ported yet).  ``early_pallas`` switches the K2/K3
    CUDA kernels on for stem + maxpool + layer1; ``fused_stages`` /
    ``cp_stages`` are not ported yet; ``pool_stride`` is the AvgPool2d(7)
    stride (1 for the reference's RNfour/RNone variants)."""

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
    a, bias = cuda_resnet.fold_stem16_weights(params["conv1_s2d"], params["bn1"], x.dtype)
    y = cuda_resnet.stem16(x16.reshape(b, 16, (h2 + 3) * w2), a, bias, H2=h2, W2=w2)
    y = F.max_pool2d(y.reshape(b, 64, h2, w2), 3, 2, 1)  # torch maxpool, NCHW
    hp, wp = y.shape[2], y.shape[3]
    flat, meta = cuda_resnet.stage_chain_weights_cp(params["layer1"], 0, y.dtype)
    out = cuda_resnet.bottleneck_chain_cp(y.reshape(b, 64, hp * wp), flat, meta=meta,
                                          H=hp, W=wp)
    return out.reshape(b, meta[-1][2], hp, wp)


def forward_extract(cfg: ResNetConfig, params: Params, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) normalized float -> (B, feature_dim_for(H, W)) f32."""
    if cfg.fused_stages or cfg.cp_stages:
        raise NotImplementedError("fused_stages / cp_stages need kernel K4 "
                                  "bottleneck_chain, not ported yet (ROADMAP.md)")
    if cfg.block != "bottleneck":
        raise NotImplementedError("basic-block ResNets (resnet18/34) are not "
                                  "ported yet (ROADMAP.md)")
    x = images.to(_dtype(cfg.compute_dtype))
    start_stage = 0
    if (cfg.early_pallas and x.shape[3] == 3
            and "conv1_s2d" in params and x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0):
        x = _early_pallas(params, x)
        start_stage = 1
    else:
        if "conv1_s2d" in params and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
            x = stem_space_to_depth(x, params["conv1_s2d"]).permute(0, 3, 1, 2)
        else:
            x = _conv(x.permute(0, 3, 1, 2), params["conv1"], stride=2)
        x = F.max_pool2d(torch.relu(_bn(x, params["bn1"])), 3, 2, 1)
    for s in range(start_stage, len(cfg.blocks_per_stage)):
        for i, blk in enumerate(params[f"layer{s + 1}"]):
            x = _bottleneck(x, blk, 2 if (s > 0 and i == 0) else 1)
    x = x.float()
    if x.shape[2] >= 7 and x.shape[3] >= 7:
        # AvgPool2d(7) with fixed windows, flattened channel-major
        return F.avg_pool2d(x, 7, stride=cfg.pool_stride).reshape(x.shape[0], -1)
    return x.mean((2, 3))  # maps below 7x7: global mean (small test inputs)


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
