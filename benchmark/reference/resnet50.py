"""ResNet-50 feature extraction as the reference pipeline runs it
(torchvision ``resnet50`` with the reference's ``forward_extract``): the
ImageNet normalisation of uint8 patches, the 7x7/2 stem, 3x3/2 max pool, four
stages of bottlenecks with the stride on the 3x3, eval BatchNorm as a per
channel scale and shift, then AvgPool2d(7) (its fixed windows, so on the 8x8
map of a 256-px patch only the top-left one) flattened channel-major.

Weights: a tree of OIHW convolutions and ``{"scale", "bias"}`` BatchNorms
(``conv1``, ``bn1``, ``layer1``..``layer4`` lists of blocks with ``conv1-3``,
``bn1-3`` and, in the first, ``downsample_conv``/``downsample_bn``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import numerics as nx

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _bn(x, p):
    return x * p["scale"].float()[:, None, None] + p["bias"].float()[:, None, None]


def _block(x, p, stride, mode):
    y = torch.relu(_bn(nx.conv2d(x, p["conv1"], mode), p["bn1"]))
    y = torch.relu(_bn(nx.conv2d(y, p["conv2"], mode, stride=stride, padding=1), p["bn2"]))
    y = _bn(nx.conv2d(y, p["conv3"], mode), p["bn3"])
    if "downsample_conv" in p:
        x = _bn(nx.conv2d(x, p["downsample_conv"], mode, stride=stride), p["downsample_bn"])
    return torch.relu(y + x)


def normalize(u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) ImageNet-normalised f32."""
    x = u8.float().permute(0, 3, 1, 2) / 255.0
    mean = torch.tensor(MEAN, device=x.device)[:, None, None]
    std = torch.tensor(STD, device=x.device)[:, None, None]
    return (x - mean) / std


def features(params: dict, u8: torch.Tensor, mode: str = "float32") -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 2048 * windows) f32 features."""
    with nx.precision(mode):
        x = normalize(u8)
        x = torch.relu(_bn(nx.conv2d(x, params["conv1"], mode, stride=2, padding=3),
                           params["bn1"]))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(4):
            for b, blk in enumerate(params[f"layer{s + 1}"]):
                x = _block(x, blk, 2 if (b == 0 and s > 0) else 1, mode)
        if x.shape[2] >= 7 and x.shape[3] >= 7:
            return F.avg_pool2d(x, 7).reshape(x.shape[0], -1)
        return x.mean((2, 3))
