"""The torch-functional oracle of the reference architectures.

Counterpart of ``tests/torch_goldens.py``, the port's own copy of what
``validate_real_weights`` compares against: the reference models' documented
math as raw ``torch.nn.functional`` calls on a torch-named state dict
(:func:`vis_forward`, :func:`vit_forward`, :func:`he2rna_eval_forward`,
:func:`resnet50_forward_extract`, :func:`uni_forward`), independent of the
port's models and converters, and random state dicts in the torchvision
ResNet-50 and timm UNI layouts (:func:`resnet50_sd`, :func:`uni_sd`).  Each
function runs on the device and in the dtype of the tensors it is given
(float64 for the checks).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# ViS, ViT, HE2RNA
# ---------------------------------------------------------------------------

def vis_forward(sd, x: torch.Tensor, depth: int, H: int, df: int, ds: int) -> torch.Tensor:
    """x: (B, N, D) -> (B, G), the reference ViS math."""
    x = x + sd["pos_emb1D"]
    for i in range(depth):
        outs = []
        for h in range(H):
            m = f"transformer.layers.{i}.0.mixers.{h}."
            loc = F.linear(x, sd[m + "f.weight"], sd[m + "f.bias"])
            loc = F.gelu(F.layer_norm(loc, (df,), sd[m + "local_norm.weight"],
                                      sd[m + "local_norm.bias"]))
            ts = F.linear(x, sd[m + "s.weight"], sd[m + "s.bias"]).mean(dim=1)
            ts = F.gelu(F.layer_norm(ts, (ds,), sd[m + "summary_norm.weight"],
                                     sd[m + "summary_norm.bias"]))
            ts = ts.unsqueeze(1).expand(-1, x.shape[1], -1)
            outs.append(F.gelu(F.linear(torch.cat([loc, ts], dim=-1),
                                        sd[m + "c.weight"], sd[m + "c.bias"])))
        p = f"transformer.layers.{i}.0."
        attn = F.linear(torch.cat(outs, dim=-1), sd[p + "projection.weight"],
                        sd[p + "projection.bias"])
        x = attn + x
        ff = f"transformer.layers.{i}.1.net."
        y = F.layer_norm(x, (x.shape[-1],), sd[ff + "0.weight"], sd[ff + "0.bias"])
        y = F.gelu(F.linear(y, sd[ff + "1.weight"], sd[ff + "1.bias"]))
        y = F.linear(y, sd[ff + "3.weight"], sd[ff + "3.bias"])
        x = x + y
    x = x.mean(dim=1)
    x = F.layer_norm(x, (x.shape[-1],), sd["linear_head.0.weight"], sd["linear_head.0.bias"])
    return F.linear(x, sd["linear_head.1.weight"], sd["linear_head.1.bias"])


def vit_forward(sd, x: torch.Tensor, depth: int, H: int, dh: int) -> torch.Tensor:
    x = x + sd["pos_emb1D"]
    B, N, D = x.shape
    for i in range(depth):
        a = f"transformer.layers.{i}.0."
        y = F.layer_norm(x, (D,), sd[a + "norm.weight"], sd[a + "norm.bias"])
        qkv = F.linear(y, sd[a + "to_qkv.weight"]).chunk(3, dim=-1)
        q, k, v = [t.reshape(B, N, H, dh).permute(0, 2, 1, 3) for t in qkv]
        attn = torch.softmax(q @ k.transpose(-1, -2) * dh ** -0.5, dim=-1)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(B, N, H * dh)
        x = F.linear(out, sd[a + "to_out.weight"]) + x
        ff = f"transformer.layers.{i}.1.net."
        y = F.layer_norm(x, (D,), sd[ff + "0.weight"], sd[ff + "0.bias"])
        y = F.gelu(F.linear(y, sd[ff + "1.weight"], sd[ff + "1.bias"]))
        x = x + F.linear(y, sd[ff + "3.weight"], sd[ff + "3.bias"])
    x = x.mean(dim=1)
    x = F.layer_norm(x, (D,), sd["linear_head.0.weight"], sd["linear_head.0.bias"])
    return F.linear(x, sd["linear_head.1.weight"], sd["linear_head.1.bias"])


def he2rna_eval_forward(sd, x_btd: torch.Tensor, n_layers: int, ks) -> torch.Tensor:
    """Eval-mode forward (k-averaged, no dropout).

    ``x_btd``: (B, T, D) tile features; internally transposed to the
    reference's (B, D, T) conv layout.
    """
    x = x_btd.transpose(1, 2)  # (B, D, T)
    mask = (x.max(dim=1, keepdim=True).values > 0).to(x.dtype)

    scores = x
    for i in range(n_layers - 1):
        w = sd[f"conv{i}.weight"]
        scores = F.relu(F.conv1d(scores, w, sd[f"conv{i}.bias"]))
    w = sd[f"conv{n_layers - 1}.weight"]
    scores = F.conv1d(scores, w, sd[f"conv{n_layers - 1}.bias"])  # (B, G, T)
    scores = scores * mask

    pred = 0
    for k in ks:
        t, _ = torch.topk(scores, int(k), dim=2, largest=True, sorted=True)
        num = torch.sum(t * mask[:, :, :k], dim=2)
        den = torch.sum(mask[:, :, :k], dim=2)
        pred = pred + (num / den) / len(ks)
    return pred


# ---------------------------------------------------------------------------
# ResNet-50, UNI
# ---------------------------------------------------------------------------

RESNET_BLOCKS = (3, 4, 6, 3)
RESNET_WIDTH = (64, 128, 256, 512)


def resnet50_sd(rng: torch.Generator) -> dict[str, torch.Tensor]:
    """Random torchvision-format resnet50 state dict (float64)."""
    sd = {}

    def conv(name, cout, cin, k):
        w = torch.randn(cout, cin, k, k, generator=rng).double()
        sd[name + ".weight"] = w * (2.0 / (cin * k * k)) ** 0.5

    def bn(name, c):
        sd[name + ".weight"] = (1 + 0.1 * torch.randn(c, generator=rng)).double()
        sd[name + ".bias"] = (0.1 * torch.randn(c, generator=rng)).double()
        sd[name + ".running_mean"] = (0.1 * torch.randn(c, generator=rng)).double()
        sd[name + ".running_var"] = (1 + 0.1 * torch.rand(c, generator=rng)).double()

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, nblocks in enumerate(RESNET_BLOCKS):
        width = RESNET_WIDTH[s]
        cout = width * 4
        for b in range(nblocks):
            pre = f"layer{s + 1}.{b}."
            conv(pre + "conv1", width, cin, 1)
            bn(pre + "bn1", width)
            conv(pre + "conv2", width, width, 3)
            bn(pre + "bn2", width)
            conv(pre + "conv3", cout, width, 1)
            bn(pre + "bn3", cout)
            if b == 0:
                conv(pre + "downsample.0", cout, cin, 1)
                bn(pre + "downsample.1", cout)
            cin = cout
    return sd


def _bn_eval(x, sd, name):
    return F.batch_norm(x, sd[name + ".running_mean"], sd[name + ".running_var"],
                        sd[name + ".weight"], sd[name + ".bias"],
                        training=False, eps=1e-5)


def resnet50_forward_extract(sd, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 3, H, W) normalized -> (B, 2048); torchvision eval-mode math."""
    x = F.relu(_bn_eval(F.conv2d(x, sd["conv1.weight"], stride=2, padding=3), sd, "bn1"))
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    for s, nblocks in enumerate(RESNET_BLOCKS):
        for b in range(nblocks):
            pre = f"layer{s + 1}.{b}."
            stride = 2 if (b == 0 and s > 0) else 1
            y = F.relu(_bn_eval(F.conv2d(x, sd[pre + "conv1.weight"]), sd, pre + "bn1"))
            y = F.relu(_bn_eval(F.conv2d(y, sd[pre + "conv2.weight"], stride=stride,
                                         padding=1), sd, pre + "bn2"))
            y = _bn_eval(F.conv2d(y, sd[pre + "conv3.weight"]), sd, pre + "bn3")
            if pre + "downsample.0.weight" in sd:
                x = _bn_eval(F.conv2d(x, sd[pre + "downsample.0.weight"], stride=stride),
                             sd, pre + "downsample.1")
            x = F.relu(y + x)
    # reference src/resnet.py:110: nn.AvgPool2d(7) — fixed 7x7 windows
    # (top-left-only on the 8x8 map from 256px patches), NOT adaptive;
    # maps <7 (tiny test inputs) fall back to global mean like our model
    if x.shape[2] >= 7 and x.shape[3] >= 7:
        return F.avg_pool2d(x, 7).flatten(1)
    return F.adaptive_avg_pool2d(x, (1, 1)).flatten(1)


def uni_sd(rng: torch.Generator, img=32, patch=8, dim=64, depth=2, heads=4,
           mlp=128) -> dict[str, torch.Tensor]:
    g = img // patch
    n_tok = g * g + 1
    sd = {
        "cls_token": (0.02 * torch.randn(1, 1, dim, generator=rng)).double(),
        "pos_embed": (0.02 * torch.randn(1, n_tok, dim, generator=rng)).double(),
        "patch_embed.proj.weight": (torch.randn(dim, 3, patch, patch, generator=rng)
                                    * (3 * patch * patch) ** -0.5).double(),
        "patch_embed.proj.bias": (0.01 * torch.randn(dim, generator=rng)).double(),
        "norm.weight": (1 + 0.1 * torch.randn(dim, generator=rng)).double(),
        "norm.bias": (0.1 * torch.randn(dim, generator=rng)).double(),
    }
    for i in range(depth):
        pre = f"blocks.{i}."
        sd[pre + "norm1.weight"] = (1 + 0.1 * torch.randn(dim, generator=rng)).double()
        sd[pre + "norm1.bias"] = (0.1 * torch.randn(dim, generator=rng)).double()
        sd[pre + "attn.qkv.weight"] = (torch.randn(3 * dim, dim, generator=rng) * dim**-0.5).double()
        sd[pre + "attn.qkv.bias"] = (0.01 * torch.randn(3 * dim, generator=rng)).double()
        sd[pre + "attn.proj.weight"] = (torch.randn(dim, dim, generator=rng) * dim**-0.5).double()
        sd[pre + "attn.proj.bias"] = (0.01 * torch.randn(dim, generator=rng)).double()
        sd[pre + "ls1.gamma"] = (1e-5 * (1 + 0.5 * torch.rand(dim, generator=rng))).double()
        sd[pre + "norm2.weight"] = (1 + 0.1 * torch.randn(dim, generator=rng)).double()
        sd[pre + "norm2.bias"] = (0.1 * torch.randn(dim, generator=rng)).double()
        sd[pre + "mlp.fc1.weight"] = (torch.randn(mlp, dim, generator=rng) * dim**-0.5).double()
        sd[pre + "mlp.fc1.bias"] = (0.01 * torch.randn(mlp, generator=rng)).double()
        sd[pre + "mlp.fc2.weight"] = (torch.randn(dim, mlp, generator=rng) * mlp**-0.5).double()
        sd[pre + "mlp.fc2.bias"] = (0.01 * torch.randn(dim, generator=rng)).double()
        sd[pre + "ls2.gamma"] = (1e-5 * (1 + 0.5 * torch.rand(dim, generator=rng))).double()
    return sd


def uni_forward(sd, x_nchw: torch.Tensor, depth=2, heads=4) -> torch.Tensor:
    """timm VisionTransformer eval math: conv patch embed, cls+pos, pre-norm
    blocks with LayerScale, final norm, CLS token output."""
    B = x_nchw.shape[0]
    x = F.conv2d(x_nchw, sd["patch_embed.proj.weight"],
                 sd["patch_embed.proj.bias"],
                 stride=sd["patch_embed.proj.weight"].shape[-1])
    x = x.flatten(2).transpose(1, 2)  # (B, N-1, D)
    cls = sd["cls_token"].expand(B, -1, -1)
    x = torch.cat([cls, x], dim=1) + sd["pos_embed"]
    D = x.shape[-1]
    dh = D // heads
    for i in range(depth):
        pre = f"blocks.{i}."
        y = F.layer_norm(x, (D,), sd[pre + "norm1.weight"], sd[pre + "norm1.bias"])
        qkv = F.linear(y, sd[pre + "attn.qkv.weight"], sd[pre + "attn.qkv.bias"])
        q, k, v = qkv.chunk(3, dim=-1)
        N = x.shape[1]
        q, k, v = [t.reshape(B, N, heads, dh).permute(0, 2, 1, 3) for t in (q, k, v)]
        attn = torch.softmax(q @ k.transpose(-1, -2) * dh**-0.5, dim=-1)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(B, N, D)
        out = F.linear(out, sd[pre + "attn.proj.weight"], sd[pre + "attn.proj.bias"])
        x = x + out * sd[pre + "ls1.gamma"]
        y = F.layer_norm(x, (D,), sd[pre + "norm2.weight"], sd[pre + "norm2.bias"])
        y = F.gelu(F.linear(y, sd[pre + "mlp.fc1.weight"], sd[pre + "mlp.fc1.bias"]))
        y = F.linear(y, sd[pre + "mlp.fc2.weight"], sd[pre + "mlp.fc2.bias"])
        x = x + y * sd[pre + "ls2.gamma"]
    x = F.layer_norm(x, (D,), sd["norm.weight"], sd["norm.bias"])
    return x[:, 0]
