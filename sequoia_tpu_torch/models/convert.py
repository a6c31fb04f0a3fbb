"""Weight conversion: reference torch state dicts <-> the port's parameter
dicts, and carry-over of the JAX package's parameter trees.

Counterpart of ``sequoia_tpu/models/convert.py`` (the ViS, ViT and HE2RNA
parts).
The port keeps the JAX package's stacked layouts, so a released fold
(``gevaertlab/sequoia-{cancer}-{fold}``, torch names
``transformer.layers.{i}.0.mixers.{h}.{f,s,c,...}``) loads directly with
:func:`vis_from_torch` and writes back with :func:`vis_to_torch`; a reference
ViT (``transformer.layers.{i}.0.{norm,to_qkv,to_out}``) goes through
:func:`vit_from_torch` and :func:`vit_to_torch`; an HE2RNA
(``conv{i}.weight`` Conv1d kernels ``(out, in, 1)``) through
:func:`he2rna_from_torch` and :func:`he2rna_to_torch`.

:func:`vis_params_from_numpy`, :func:`vit_params_from_numpy`,
:func:`he2rna_params_from_numpy`, :func:`resnet_params_from_numpy` and
:func:`uni_params_from_numpy` turn the
JAX package's parameter trees, given as numpy arrays (``jax.device_get`` or
``np.asarray`` of each leaf), into the port's, so one set of weights can run
through both implementations.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from sequoia_tpu_torch.models.he2rna import HE2RNAConfig
from sequoia_tpu_torch.models.vis import ViSConfig
from sequoia_tpu_torch.models.vit import ViTConfig


def _np(x) -> np.ndarray:
    """torch tensor / array-like -> float32 numpy (host)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _t(x) -> torch.Tensor:
    return torch.as_tensor(_np(x).copy())


# ---------------------------------------------------------------------------
# ViS
# ---------------------------------------------------------------------------

def vis_config_from_state_dict(sd) -> ViSConfig:
    """Infer the architecture from a torch state dict's shapes."""
    num_clusters, input_dim = _np(sd["pos_emb1D"]).shape
    depth = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("transformer.layers."))
    nheads = 1 + max(int(k.split(".")[5]) for k in sd if ".mixers." in k)
    dim_f = tuple(sd["transformer.layers.0.0.mixers.0.f.weight"].shape)[0]
    dim_s = tuple(sd["transformer.layers.0.0.mixers.0.s.weight"].shape)[0]
    dim_c = tuple(sd["transformer.layers.0.0.mixers.0.c.weight"].shape)[0]
    num_outputs = tuple(sd["linear_head.1.weight"].shape)[0]
    return ViSConfig(num_outputs=num_outputs, input_dim=input_dim, depth=depth,
                     nheads=nheads, dim_f=dim_f, dim_s=dim_s, dim_c=dim_c,
                     num_clusters=num_clusters)


def vis_from_torch(sd, cfg: ViSConfig | None = None):
    """Torch ViS state dict -> (cfg, params) in the stacked layout (f32,
    on the CPU)."""
    if cfg is None:
        cfg = vis_config_from_state_dict(sd)
    H = cfg.nheads

    def get(name):
        return _np(sd[name])

    blocks: dict[str, list[np.ndarray]] = {k: [] for k in (
        "wf", "bf", "ws", "bs", "wc", "bc",
        "ln_f_scale", "ln_f_bias", "ln_s_scale", "ln_s_bias",
        "wproj", "bproj", "ln_ff_scale", "ln_ff_bias", "w1", "b1", "w2", "b2")}
    for i in range(cfg.depth):
        mix = f"transformer.layers.{i}.0."

        def heads(name, op):
            return op([get(mix + f"mixers.{h}.{name}") for h in range(H)])

        # per-head f/s linears (out, in) fused to (D, H*width)
        blocks["wf"].append(np.concatenate([get(mix + f"mixers.{h}.f.weight").T
                                            for h in range(H)], axis=1))
        blocks["bf"].append(heads("f.bias", np.concatenate))
        blocks["ws"].append(np.concatenate([get(mix + f"mixers.{h}.s.weight").T
                                            for h in range(H)], axis=1))
        blocks["bs"].append(heads("s.bias", np.concatenate))
        blocks["wc"].append(np.stack([get(mix + f"mixers.{h}.c.weight").T
                                      for h in range(H)]))
        blocks["bc"].append(heads("c.bias", np.stack))
        blocks["ln_f_scale"].append(heads("local_norm.weight", np.stack))
        blocks["ln_f_bias"].append(heads("local_norm.bias", np.stack))
        blocks["ln_s_scale"].append(heads("summary_norm.weight", np.stack))
        blocks["ln_s_bias"].append(heads("summary_norm.bias", np.stack))
        blocks["wproj"].append(get(mix + "projection.weight").T)
        blocks["bproj"].append(get(mix + "projection.bias"))
        ff = f"transformer.layers.{i}.1.net."
        blocks["ln_ff_scale"].append(get(ff + "0.weight"))
        blocks["ln_ff_bias"].append(get(ff + "0.bias"))
        blocks["w1"].append(get(ff + "1.weight").T)
        blocks["b1"].append(get(ff + "1.bias"))
        blocks["w2"].append(get(ff + "3.weight").T)
        blocks["b2"].append(get(ff + "3.bias"))

    params = {
        "pos_emb": _t(get("pos_emb1D")),
        "blocks": {k: _t(np.stack(v)) for k, v in blocks.items()},
        "head_ln_scale": _t(get("linear_head.0.weight")),
        "head_ln_bias": _t(get("linear_head.0.bias")),
        "head_w": _t(get("linear_head.1.weight").T),
        "head_b": _t(get("linear_head.1.bias")),
    }
    return cfg, params


def vis_to_torch(cfg: ViSConfig, params) -> "OrderedDict[str, np.ndarray]":
    """The port's ViS params -> torch-named state dict (numpy values)."""
    H, df, ds = cfg.nheads, cfg.dim_f, cfg.dim_s
    b = {k: _np(v) for k, v in params["blocks"].items()}
    sd: OrderedDict[str, np.ndarray] = OrderedDict()
    sd["pos_emb1D"] = _np(params["pos_emb"])
    for i in range(cfg.depth):
        mix = f"transformer.layers.{i}.0."
        for h in range(H):
            m = mix + f"mixers.{h}."
            sd[m + "local_norm.weight"] = b["ln_f_scale"][i, h]
            sd[m + "local_norm.bias"] = b["ln_f_bias"][i, h]
            sd[m + "summary_norm.weight"] = b["ln_s_scale"][i, h]
            sd[m + "summary_norm.bias"] = b["ln_s_bias"][i, h]
            sd[m + "s.weight"] = b["ws"][i][:, h * ds:(h + 1) * ds].T
            sd[m + "s.bias"] = b["bs"][i][h * ds:(h + 1) * ds]
            sd[m + "f.weight"] = b["wf"][i][:, h * df:(h + 1) * df].T
            sd[m + "f.bias"] = b["bf"][i][h * df:(h + 1) * df]
            sd[m + "c.weight"] = b["wc"][i, h].T
            sd[m + "c.bias"] = b["bc"][i, h]
        sd[mix + "projection.weight"] = b["wproj"][i].T
        sd[mix + "projection.bias"] = b["bproj"][i]
        ff = f"transformer.layers.{i}.1.net."
        sd[ff + "0.weight"] = b["ln_ff_scale"][i]
        sd[ff + "0.bias"] = b["ln_ff_bias"][i]
        sd[ff + "1.weight"] = b["w1"][i].T
        sd[ff + "1.bias"] = b["b1"][i]
        sd[ff + "3.weight"] = b["w2"][i].T
        sd[ff + "3.bias"] = b["b2"][i]
    sd["linear_head.0.weight"] = _np(params["head_ln_scale"])
    sd["linear_head.0.bias"] = _np(params["head_ln_bias"])
    sd["linear_head.1.weight"] = _np(params["head_w"]).T
    sd["linear_head.1.bias"] = _np(params["head_b"])
    return sd


def vis_params_from_numpy(params):
    """A JAX ViS parameter tree (numpy leaves) -> the port's params: the
    layouts are the same, only the containers change."""
    return {k: ({kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else _t(v)) for k, v in params.items()}


def uni_params_from_numpy(params):
    """A JAX UNI ViT parameter tree (numpy leaves) -> the port's params
    (``models/uni_vit.py``): the same stacked ``(in, out)`` layout, only
    the containers change."""
    return vis_params_from_numpy(params)


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

def vit_config_from_state_dict(sd) -> ViTConfig:
    """Infer the architecture from a torch ViT state dict's shapes
    (``dim_head`` is 64 at every reference call site; the heads follow)."""
    num_clusters, dim = _np(sd["pos_emb1D"]).shape
    depth = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("transformer.layers."))
    inner = tuple(sd["transformer.layers.0.0.to_qkv.weight"].shape)[0] // 3
    mlp_dim = tuple(sd["transformer.layers.0.1.net.1.weight"].shape)[0]
    num_outputs = tuple(sd["linear_head.1.weight"].shape)[0]
    dim_head = 64 if inner % 64 == 0 else inner
    return ViTConfig(num_outputs=num_outputs, dim=dim, depth=depth, heads=inner // dim_head,
                     dim_head=dim_head, mlp_dim=mlp_dim, num_clusters=num_clusters)


_VIT_BLOCK = (  # (stacked key, torch name within layer i, transposed)
    ("ln_attn_scale", "0.norm.weight", False), ("ln_attn_bias", "0.norm.bias", False),
    ("w_qkv", "0.to_qkv.weight", True), ("w_out", "0.to_out.weight", True),
    ("ln_ff_scale", "1.net.0.weight", False), ("ln_ff_bias", "1.net.0.bias", False),
    ("w1", "1.net.1.weight", True), ("b1", "1.net.1.bias", False),
    ("w2", "1.net.3.weight", True), ("b2", "1.net.3.bias", False))


def vit_from_torch(sd, cfg: ViTConfig | None = None):
    """Torch ViT state dict -> (cfg, params) in the stacked layout (f32, on
    the CPU)."""
    if cfg is None:
        cfg = vit_config_from_state_dict(sd)

    def layer(i, name, transposed):
        w = _np(sd[f"transformer.layers.{i}.{name}"])
        return w.T if transposed else w

    params = {
        "pos_emb": _t(sd["pos_emb1D"]),
        "blocks": {key: _t(np.stack([layer(i, name, tr) for i in range(cfg.depth)]))
                   for key, name, tr in _VIT_BLOCK},
        "head_ln_scale": _t(sd["linear_head.0.weight"]),
        "head_ln_bias": _t(sd["linear_head.0.bias"]),
        "head_w": _t(_np(sd["linear_head.1.weight"]).T),
        "head_b": _t(sd["linear_head.1.bias"]),
    }
    return cfg, params


def vit_to_torch(cfg: ViTConfig, params) -> "OrderedDict[str, np.ndarray]":
    """The port's ViT params -> torch-named state dict (numpy values), in
    the reference module's order."""
    b = {k: _np(v) for k, v in params["blocks"].items()}
    sd: OrderedDict[str, np.ndarray] = OrderedDict()
    sd["pos_emb1D"] = _np(params["pos_emb"])
    for i in range(cfg.depth):
        for key, name, transposed in _VIT_BLOCK:
            sd[f"transformer.layers.{i}.{name}"] = b[key][i].T if transposed else b[key][i]
    sd["linear_head.0.weight"] = _np(params["head_ln_scale"])
    sd["linear_head.0.bias"] = _np(params["head_ln_bias"])
    sd["linear_head.1.weight"] = _np(params["head_w"]).T
    sd["linear_head.1.bias"] = _np(params["head_b"])
    return sd


def vit_params_from_numpy(params):
    """A JAX ViT parameter tree (numpy leaves) -> the port's params
    (``models/vit.py``): the same stacked layout, only the containers
    change."""
    return vis_params_from_numpy(params)


# ---------------------------------------------------------------------------
# HE2RNA
# ---------------------------------------------------------------------------

def he2rna_config_from_state_dict(sd, ks=HE2RNAConfig.ks) -> HE2RNAConfig:
    """Infer the architecture from a torch HE2RNA state dict; a whole-module
    pickle's ``__ks__`` (kept by ``checkpoint.load_torch_checkpoint``) gives
    the trained k sweep, which the model must be evaluated with."""
    n = 0
    while f"conv{n}.weight" in sd:
        n += 1
    if "__ks__" in sd:
        ks = tuple(int(k) for k in np.asarray(sd["__ks__"]).tolist())
    dims = [tuple(sd["conv0.weight"].shape)[1]]
    dims += [tuple(sd[f"conv{i}.weight"].shape)[0] for i in range(n)]
    return HE2RNAConfig(input_dim=dims[0], output_dim=dims[-1], layers=tuple(dims[1:-1]),
                        ks=tuple(ks))


def he2rna_from_torch(sd, cfg: HE2RNAConfig | None = None):
    """Torch HE2RNA state dict -> (cfg, params): ``{"w": [(in, out)],
    "b": [(out,)]}``, f32 on the CPU."""
    if cfg is None:
        cfg = he2rna_config_from_state_dict(sd)
    ws, bs = [], []
    for i in range(len(cfg.layers) + 1):
        ws.append(_t(_np(sd[f"conv{i}.weight"])[:, :, 0].T))  # Conv1d (out, in, 1)
        bs.append(_t(sd[f"conv{i}.bias"]))
    return cfg, {"w": ws, "b": bs}


def he2rna_to_torch(cfg: HE2RNAConfig, params) -> "OrderedDict[str, np.ndarray]":
    """The port's HE2RNA params -> torch-named state dict (numpy values)."""
    sd: OrderedDict[str, np.ndarray] = OrderedDict()
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        sd[f"conv{i}.weight"] = _np(w).T[:, :, None]
        sd[f"conv{i}.bias"] = _np(b)
    return sd


def he2rna_params_from_numpy(params):
    """A JAX HE2RNA parameter tree (numpy leaves) -> the port's params: the
    same ``{"w": [...], "b": [...]}`` layout."""
    return {"w": [_t(w) for w in params["w"]], "b": [_t(b) for b in params["b"]]}


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------

def resnet_params_from_numpy(params):
    """A JAX ResNet parameter tree (HWIO conv kernels, folded-BN
    ``{"scale", "bias"}``) -> the port's (OIHW conv weights, the same BN
    dicts)."""
    def conv(w):  # HWIO -> OIHW
        return _t(_np(w).transpose(3, 2, 0, 1))

    def convert(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k.startswith("conv") or k == "downsample_conv":
                    out[k] = conv(v)
                elif isinstance(v, (dict, list)):
                    out[k] = convert(v)
                else:
                    out[k] = _t(v)
            return out
        return [convert(v) for v in node]

    return convert(params)
