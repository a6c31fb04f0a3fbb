"""Seeded weights, drawn on the device in a few large calls and handed
alike to the program and to the plain reference.  The trees are in the
layout the program's loaders produce (OIHW convolutions with eval
BatchNorm folded to a scale and a shift; (in, out) GEMM weights stacked over
depth), so nothing is converted on the host."""

from __future__ import annotations

import math

import torch


class _Flat:
    """Leaves cut from one buffer of standard draws: ``normal`` or
    ``uniform`` on [-1, 1), each leaf scaled after the draw."""

    def __init__(self, gen: torch.Generator, shapes: list[tuple], kind: str):
        total = sum(math.prod(s) for s in shapes)
        buf = torch.empty(total, device=gen.device)
        if kind == "normal":
            buf.normal_(generator=gen)
        else:
            buf.uniform_(-1.0, 1.0, generator=gen)
        self.buf, self.pos = buf, 0

    def take(self, shape: tuple, scale: float) -> torch.Tensor:
        n = math.prod(shape)
        t = self.buf[self.pos:self.pos + n].view(shape).mul_(scale)
        self.pos += n
        return t


def resnet50(gen: torch.Generator) -> dict:
    """He-normal convolutions, identity BatchNorm (the scale 1, the shift
    0), torchvision's ResNet-50 shapes."""
    dev = gen.device
    convs = [((64, 3, 7, 7),)]
    cin = 64
    plan = []
    for s, (width, blocks) in enumerate(((64, 3), (128, 4), (256, 6), (512, 3))):
        cout = width * 4
        for b in range(blocks):
            shapes = [(width, cin, 1, 1), (width, width, 3, 3), (cout, width, 1, 1)]
            if b == 0:
                shapes.append((cout, cin, 1, 1))
            plan.append((s, b, width, cout, shapes))
            convs.extend((sh,) for sh in shapes)
            cin = cout
    flat = _Flat(gen, [c[0] for c in convs], "normal")

    def conv(shape):
        return flat.take(shape, math.sqrt(2.0 / (shape[1] * shape[2] * shape[3])))

    def bn(c):
        return {"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev)}

    params = {"conv1": conv((64, 3, 7, 7)), "bn1": bn(64)}
    for s, b, width, cout, shapes in plan:
        blk = {"conv1": conv(shapes[0]), "bn1": bn(width), "conv2": conv(shapes[1]),
               "bn2": bn(width), "conv3": conv(shapes[2]), "bn3": bn(cout)}
        if b == 0:
            blk["downsample_conv"] = conv(shapes[3])
            blk["downsample_bn"] = bn(cout)
        params.setdefault(f"layer{s + 1}", []).append(blk)
    return params


def uni_vit(gen: torch.Generator, *, img: int, patch: int, dim: int, depth: int,
            mlp: int, layer_scale: float) -> dict:
    """timm ViT-L/16 shapes; GEMM weights normal with the fan-in's inverse
    root as their deviation, biases zero, LayerNorms 1 and 0, the CLS token
    and position embedding normal at 0.02, every LayerScale gamma
    ``layer_scale``."""
    dev = gen.device
    pdim, tokens = patch * patch * 3, (img // patch) ** 2 + 1
    shapes = [(pdim, dim), (1, dim), (tokens, dim), (depth, dim, 3 * dim),
              (depth, dim, dim), (depth, dim, mlp), (depth, mlp, dim)]
    flat = _Flat(gen, shapes, "normal")

    def full(shape, v):
        return torch.full(shape, float(v), device=dev)

    params = {"patch_w": flat.take(shapes[0], pdim ** -0.5), "patch_b": full((dim,), 0),
              "cls_token": flat.take(shapes[1], 0.02), "pos_emb": flat.take(shapes[2], 0.02),
              "norm_scale": full((dim,), 1), "norm_bias": full((dim,), 0)}
    params["blocks"] = {
        "ln1_scale": full((depth, dim), 1), "ln1_bias": full((depth, dim), 0),
        "w_qkv": flat.take(shapes[3], dim ** -0.5), "b_qkv": full((depth, 3 * dim), 0),
        "w_proj": flat.take(shapes[4], dim ** -0.5), "b_proj": full((depth, dim), 0),
        "ls1": full((depth, dim), layer_scale),
        "ln2_scale": full((depth, dim), 1), "ln2_bias": full((depth, dim), 0),
        "w_fc1": flat.take(shapes[5], dim ** -0.5), "b_fc1": full((depth, mlp), 0),
        "w_fc2": flat.take(shapes[6], mlp ** -0.5), "b_fc2": full((depth, dim), 0),
        "ls2": full((depth, dim), layer_scale)}
    return params


def vis_fold(gen: torch.Generator, *, dim: int, depth: int, heads: int, dim_f: int,
             dim_s: int, dim_c: int, genes: int, tokens: int) -> dict:
    """One ViS fold with torch's defaults: every Linear's weight and bias
    uniform within the fan-in's inverse root, LayerNorms 1 and 0, the
    position embedding standard normal."""
    dev = gen.device
    h = heads
    lin = [(depth, dim, h * dim_f), (depth, h * dim_f), (depth, dim, h * dim_s),
           (depth, h * dim_s), (depth, h, dim_f + dim_s, dim_c), (depth, h, dim_c),
           (depth, h * dim_c, dim), (depth, dim), (depth, dim, dim), (depth, dim),
           (depth, dim, dim), (depth, dim), (dim, genes), (genes,)]
    fans = [dim, dim, dim, dim, dim_f + dim_s, dim_f + dim_s, h * dim_c, h * dim_c,
            dim, dim, dim, dim, dim, dim]
    flat = _Flat(gen, lin, "uniform")
    w = [flat.take(s, f ** -0.5) for s, f in zip(lin, fans)]
    pos = torch.randn((tokens, dim), generator=gen, device=dev)

    def full(shape, v):
        return torch.full(shape, float(v), device=dev)

    blocks = {"wf": w[0], "bf": w[1], "ws": w[2], "bs": w[3], "wc": w[4], "bc": w[5],
              "ln_f_scale": full((depth, h, dim_f), 1), "ln_f_bias": full((depth, h, dim_f), 0),
              "ln_s_scale": full((depth, h, dim_s), 1), "ln_s_bias": full((depth, h, dim_s), 0),
              "wproj": w[6], "bproj": w[7],
              "ln_ff_scale": full((depth, dim), 1), "ln_ff_bias": full((depth, dim), 0),
              "w1": w[8], "b1": w[9], "w2": w[10], "b2": w[11]}
    return {"pos_emb": pos, "blocks": blocks, "head_ln_scale": full((dim,), 1),
            "head_ln_bias": full((dim,), 0), "head_w": w[12], "head_b": w[13]}
