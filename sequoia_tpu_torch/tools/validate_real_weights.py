"""Check that the reference's released weights load and agree, offline.

Counterpart of ``tools/validate_real_weights.py``.  The interop claim is
that the reference's released artifacts load directly:

* the HuggingFace fold checkpoints ``gevaertlab/sequoia-{cancer}-{fold}``
  (reference ``src/tformer_lin.py:80``, ``README.md:137-142``),
* torchvision's ImageNet ResNet-50 weights (``src/resnet.py:13,376-379``),
* MahmoodLab's UNI ViT-L ``pytorch_model.bin``
  (``pre_processing/compute_features_hdf5.py:62-68``).

Each artifact is read with the port's loaders (``train/checkpoint.py``,
``models/convert.py``, ``models/resnet.resnet50_from_torch``,
``models/uni_vit.uni_from_torch``), and one seeded input runs through the
port's forward with its kernels, the port's plain forward, and the float64
torch-functional oracle (``tools/goldens.py``).  Each forward gives one row of
deltas against the oracle: the ViS fold through K1 (``vis_blocks_fused``,
where the fold fits its packed layout), the ResNet-50 extractor with
``early_pallas`` (K2, K3) and with ``fused_stages=(1, 2, 3, 4)`` (K4), and the
plain forward of every artifact.  On the CPU the kernel routes run the
kernels' plain versions.  A row passes at max |delta| <= 1e-2 and r >
0.99999, the JAX tool's bound.

The tool downloads nothing.  It reads ``--local-hub`` and, where given,
``--cache`` (a HuggingFace cache: ``models--{org}--{name}/snapshots/*``,
``resnet50.pth``).  With neither, it writes a "pending: no local hub"
section and exits 0; an artifact that is present but does not load, or
breaks the bound, exits 1.  The rows go into ``--notes``
(``docs/PARITY_NOTES_TORCH.md``; never the JAX package's
``docs/PARITY_NOTES.md``).

    python -m sequoia_tpu_torch.tools.validate_real_weights --local-hub /ckpts
    python -m sequoia_tpu_torch.tools.validate_real_weights --dry-run
    python -m sequoia_tpu_torch.tools.validate_real_weights --device cpu ...

Layout under ``--local-hub`` (any subset):

    sequoia-{cancer}-{fold}/  config.json + pytorch_model.bin | model.safetensors
    resnet50.pth              torchvision state dict
    uni/pytorch_model.bin     timm ViT-L/16 state dict (config.json: num_heads
                              where the width is not 1024)
    vit-test.pt, he2rna-test.pt, he2rna-module.pt   converter fixtures
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from datetime import date

import numpy as np
import torch

from sequoia_tpu_torch import _build
from sequoia_tpu_torch.models import convert, he2rna, resnet, uni_vit, vis, vit
from sequoia_tpu_torch.ops import cuda_vis
from sequoia_tpu_torch.ops.nn import precision
from sequoia_tpu_torch.tools import goldens
from sequoia_tpu_torch.train import checkpoint
from sequoia_tpu_torch.utils.device import resolve_device, tree_to

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_NOTES = os.path.join(_REPO, "docs", "PARITY_NOTES_TORCH.md")
JAX_NOTES = os.path.join(_REPO, "docs", "PARITY_NOTES.md")
DEFAULT_CANCERS = ("brca", "luad", "lusc", "kirc", "coad", "gbm", "prad",
                   "thca", "skcm", "stad", "paad", "ucec", "hnsc", "lihc",
                   "lgg", "kirp")
NOTES_BEGIN = "<!-- validate_real_weights_torch:begin -->"
NOTES_END = "<!-- validate_real_weights_torch:end -->"
MAX_ABS, MIN_CORR = 1e-2, 0.99999
# the converter fixtures: no released artifact exists for these
FIXTURES = (("vit-test.pt", "vit"), ("he2rna-test.pt", "he2rna"),
            ("he2rna-module.pt", "he2rna"))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# artifacts

def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """A hub snapshot directory or a ``.pt``/``.pth``/``.bin`` file (state
    dict or whole-module pickle) -> numpy state dict."""
    if os.path.isdir(path):
        return checkpoint.load_hf_vis_state_dict(path)
    return checkpoint.load_torch_checkpoint(path)


def _oracle_sd(sd, device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device, torch.float64)
            for k, v in sd.items() if not k.startswith("__")}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().double().cpu().numpy()


def _resolve_local(root: str | None, name: str, kind: str) -> str | None:
    if not root:
        return None
    cand = {"vis": [os.path.join(root, name.split("/")[-1])],
            "resnet50": [os.path.join(root, "resnet50.pth"), os.path.join(root, "resnet50.pt")],
            "uni": [os.path.join(root, "uni", "pytorch_model.bin"), os.path.join(root, "uni")],
            }[kind]
    return next((c for c in cand if os.path.exists(c)), None)


def _resolve_cache(cache: str | None, name: str, kind: str) -> str | None:
    """An artifact already in a HuggingFace cache directory (or, for
    ResNet-50, a ``resnet50.pth`` there); never a download."""
    if not cache:
        return None
    if kind == "resnet50":
        cand = [os.path.join(cache, f) for f in ("resnet50.pth", "resnet50-0676ba61.pth")]
        return next((c for c in cand if os.path.exists(c)), None)
    repo = "MahmoodLab/UNI" if kind == "uni" else name
    snaps = sorted(glob.glob(os.path.join(cache, "models--" + repo.replace("/", "--"),
                                          "snapshots", "*")), key=os.path.getmtime)
    return snaps[-1] if snaps else None


# ---------------------------------------------------------------------------
# forwards: each returns {route: (B, out) array} with the float64 "oracle"

def vis_forwards(sd, x: np.ndarray, device) -> tuple[dict, dict]:
    cfg, params = convert.vis_from_torch(dict(sd))
    params = tree_to(params, device)
    xt = torch.as_tensor(x, device=device)
    outs = {"plain": _host(vis.apply(cfg, params, xt))}
    ok, why = cuda_vis.kernel_takes(cfg, torch.float32)
    if ok:
        packed = cuda_vis.pack_vis_blocks(cfg, params, torch.float32)
        outs["K1 vis_blocks_fused"] = np.concatenate(
            [_host(cuda_vis.vis_apply_fused(cfg, params, packed, xt[i:i + 1]))
             for i in range(xt.shape[0])])
    outs["oracle"] = _host(goldens.vis_forward(
        _oracle_sd(sd, device), xt.double(), depth=cfg.depth, H=cfg.nheads,
        df=cfg.dim_f, ds=cfg.dim_s))
    extra = {"genes": cfg.num_outputs, "input_dim": cfg.input_dim}
    if not ok:
        extra["kernel"] = f"K1 not run: {why}"
    return outs, extra


def vit_forwards(sd, x: np.ndarray, device) -> tuple[dict, dict]:
    cfg, params = convert.vit_from_torch(dict(sd))
    params = tree_to(params, device)
    xt = torch.as_tensor(x, device=device)
    outs = {"plain": _host(vit.apply(cfg, params, xt)),
            "oracle": _host(goldens.vit_forward(_oracle_sd(sd, device), xt.double(),
                                                depth=cfg.depth, H=cfg.heads,
                                                dh=cfg.dim_head))}
    return outs, {"genes": cfg.num_outputs, "dim": cfg.dim}


def he2rna_forwards(sd, x: np.ndarray, device) -> tuple[dict, dict]:
    cfg, params = convert.he2rna_from_torch(dict(sd))
    params = tree_to(params, device)
    xt = torch.as_tensor(x, device=device)
    with torch.no_grad():
        plain = he2rna.apply(cfg, params, xt)
    outs = {"plain": _host(plain),
            "oracle": _host(goldens.he2rna_eval_forward(
                _oracle_sd(sd, device), xt.double(), n_layers=len(cfg.layers) + 1,
                ks=cfg.ks))}
    return outs, {"genes": cfg.output_dim, "ks": list(cfg.ks)}


RESNET_ROUTES = {"plain": {}, "K2+K3 early_pallas": {"early_pallas": True},
                 "K4 fused_stages": {"fused_stages": (1, 2, 3, 4)}}


def resnet50_forwards(sd, u8: np.ndarray, device) -> tuple[dict, dict]:
    """The extractor with each route's options; the oracle normalizes with
    the ImageNet transform before ``forward_extract``, as the reference does
    (``compute_features_hdf5.py:50-56``)."""
    params = tree_to(resnet.resnet50_from_torch(sd), device)
    ut = torch.as_tensor(u8, device=device)
    outs = {route: _host(resnet.extract_from_uint8(resnet.ResNetConfig(**opts), params, ut))
            for route, opts in RESNET_ROUTES.items()}
    x = resnet.preprocess_uint8(ut).double().permute(0, 3, 1, 2)
    outs["oracle"] = _host(goldens.resnet50_forward_extract(_oracle_sd(sd, device), x))
    return outs, {"feature_dim": outs["plain"].shape[-1]}


def uni_forwards(sd, u8: np.ndarray, device, heads: int | None = None) -> tuple[dict, dict]:
    cfg, params = uni_vit.uni_from_torch(sd, heads=heads)
    params = tree_to(params, device)
    ut = torch.as_tensor(u8, device=device)
    x = resnet.preprocess_uint8(ut).double().permute(0, 3, 1, 2)
    outs = {"plain": _host(uni_vit.extract_from_uint8(cfg, params, ut)),
            "oracle": _host(goldens.uni_forward(_oracle_sd(sd, device), x, depth=cfg.depth,
                                                heads=cfg.heads))}
    return outs, {"feature_dim": outs["plain"].shape[-1]}


def _uni_heads(path: str) -> int | None:
    """The head count from a ``config.json`` beside the weights (a fused-qkv
    state dict does not record it; the 1024-wide UNI infers 16)."""
    cfg_json = os.path.join(path if os.path.isdir(path) else os.path.dirname(path),
                            "config.json")
    if not os.path.exists(cfg_json):
        return None
    with open(cfg_json) as f:
        meta = json.load(f)
    return meta.get("num_heads") or meta.get("heads")


# ---------------------------------------------------------------------------
# checks: one seeded input per artifact -> {route: delta row}

def check(kind: str, path: str, rng: np.random.Generator, device) -> dict[str, dict]:
    sd = load_state_dict(path)
    if kind == "vis":
        n, d = np.asarray(sd["pos_emb1D"]).shape
        outs, extra = vis_forwards(sd, rng.normal(size=(2, n, d)).astype(np.float32), device)
    elif kind == "vit":
        n, d = np.asarray(sd["pos_emb1D"]).shape
        outs, extra = vit_forwards(sd, rng.normal(size=(2, n, d)).astype(np.float32), device)
    elif kind == "he2rna":
        d = np.asarray(sd["conv0.weight"]).shape[1]
        outs, extra = he2rna_forwards(sd, rng.normal(size=(2, 100, d)).astype(np.float32),
                                      device)
    elif kind == "resnet50":
        outs, extra = resnet50_forwards(
            sd, rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8), device)
    elif kind == "uni":
        heads = _uni_heads(path)
        side = int(round((np.asarray(sd["pos_embed"]).shape[1] - 1) ** 0.5)) * \
            np.asarray(sd["patch_embed.proj.weight"]).shape[-1]
        outs, extra = uni_forwards(sd, rng.integers(0, 256, (2, side, side, 3), dtype=np.uint8),
                                   device, heads=heads)
    else:
        raise ValueError(f"unknown artifact kind {kind!r}")
    oracle = outs.pop("oracle")
    rows = {}
    for route, y in outs.items():
        row = delta_row(y, oracle, extra)
        if route != "plain":
            row["vs_plain_max_abs"] = float(np.abs(y - outs["plain"]).max())
        rows[route] = row
    return rows


def delta_row(ours: np.ndarray, theirs: np.ndarray, extra: dict) -> dict:
    d = np.abs(ours - theirs)
    denom = np.maximum(np.abs(theirs), 1e-6)
    row = {"max_abs": float(d.max()), "max_rel": float((d / denom).max()),
           "corr": float(np.corrcoef(ours.ravel(), theirs.ravel())[0, 1])}
    row.update(extra)
    row["pass"] = bool(row["max_abs"] <= MAX_ABS and row["corr"] > MIN_CORR)
    return row


# ---------------------------------------------------------------------------
# notes

def write_notes(notes_path: str, rows: dict[str, dict], pending: list[str],
                reason: str, device: str) -> None:
    """Replace (or append) this tool's section of ``notes_path``."""
    lines = [NOTES_BEGIN,
             "## Released-weight validation of the PyTorch port "
             f"(sequoia_tpu_torch.tools.validate_real_weights, last run {date.today()}, "
             f"{device})", ""]
    if rows:
        lines += ["| artifact [route] | max abs delta | max rel delta | corr | pass |",
                  "|---|---|---|---|---|"]
        for name, r in sorted(rows.items()):
            lines.append(f"| {name} | {r['max_abs']:.2e} | {r['max_rel']:.2e} | "
                         f"{r['corr']:.6f} | {'PASS' if r['pass'] else 'FAIL'} |")
        lines.append("")
    if pending:
        lines += [f"**Pending: {reason}.** These artifacts remain unvalidated:", ""]
        lines += [f"- {p}" for p in pending]
        lines.append("")
    lines.append(NOTES_END)
    block = "\n".join(lines)
    text = ""
    if os.path.exists(notes_path):
        with open(notes_path) as f:
            text = f.read()
    if NOTES_BEGIN in text and NOTES_END in text:
        text = (text[:text.index(NOTES_BEGIN)] + block
                + text[text.index(NOTES_END) + len(NOTES_END):])
    else:
        text = text.rstrip() + ("\n\n" if text.strip() else "") + block + "\n"
    os.makedirs(os.path.dirname(os.path.abspath(notes_path)), exist_ok=True)
    with open(notes_path, "w") as f:
        f.write(text)


# ---------------------------------------------------------------------------

def plan(args) -> list[tuple[str, str, str | None]]:
    """(name, kind, path or None) of every artifact to validate."""
    out: list[tuple[str, str, str | None]] = []
    for cancer in args.cancers.split(","):
        for fold in args.folds.split(","):
            out.append((f"gevaertlab/sequoia-{cancer.strip()}-{fold.strip()}", "vis", None))
    if not args.skip_resnet:
        out.append(("torchvision/resnet50-IMAGENET1K_V1", "resnet50", None))
    if not args.skip_uni:
        out.append(("MahmoodLab/UNI", "uni", None))
    if args.local_hub:
        for fname, kind in FIXTURES:
            p = os.path.join(args.local_hub, fname)
            if os.path.exists(p):
                out.append((f"local/{fname}", kind, p))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate the port's loaders and forwards against released weights")
    ap.add_argument("--cancers", default="brca",
                    help="comma list of sequoia-{cancer}-{fold} cohorts "
                         f"(released: {','.join(DEFAULT_CANCERS)})")
    ap.add_argument("--folds", default="0", help="comma list of folds per cancer (released: 0-4)")
    ap.add_argument("--local-hub", default=None,
                    help="directory of offline snapshots (see the module doc)")
    ap.add_argument("--cache", default=None,
                    help="a HuggingFace cache directory to read snapshots from (no download)")
    ap.add_argument("--notes", default=DEFAULT_NOTES)
    ap.add_argument("--skip-uni", action="store_true")
    ap.add_argument("--skip-resnet", action="store_true")
    ap.add_argument("--dry-run", action="store_true",
                    help="list the artifact plan without loading anything")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without CUDA) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    if os.path.abspath(args.notes) == JAX_NOTES:
        raise SystemExit(f"validate_real_weights: {JAX_NOTES} belongs to the JAX package's "
                         "tool; write the port's rows elsewhere")

    artifacts = plan(args)
    if args.dry_run:
        for name, kind, _ in artifacts:
            print(f"would validate {kind}: {name}")
        return 0

    device = resolve_device(args.device)
    if device.type == "cuda":
        precision()  # TF32 off: f32 means IEEE f32 for the plain forwards
    rng = np.random.default_rng(0)
    rows: dict[str, dict] = {}
    pending: list[str] = []
    for name, kind, src in artifacts:
        src = src or _resolve_local(args.local_hub, name, kind) or _resolve_cache(
            args.cache, name, kind)
        if src is None:
            pending.append(f"{name} ({kind})")
            continue
        log(f"validating {kind}: {name} <- {src}")
        try:
            for route, row in check(kind, src, rng, device).items():
                rows[f"{name} [{route}]"] = row
                log(f"  {route}: {row}")
        except Exception as e:  # noqa: BLE001 -- one bad artifact must not stop the others
            rows[f"{name} [load]"] = {"max_abs": float("nan"), "max_rel": float("nan"),
                                      "corr": float("nan"), "pass": False,
                                      "error": f"{type(e).__name__}: {e}"}
            log(f"  FAILED: {type(e).__name__}: {e}")

    reason = ("no local hub" if not (args.local_hub or args.cache)
              else "not in the local hub or cache")
    write_notes(args.notes, rows, pending, reason, str(device))
    n_pass = sum(r["pass"] for r in rows.values())
    print(json.dumps({"validated": len(rows), "passed": n_pass, "pending": len(pending),
                      "notes": args.notes, "device": str(device),
                      "launches": dict(_build.LAUNCHES),
                      "rows": rows}))
    return 1 if n_pass < len(rows) else 0


if __name__ == "__main__":
    raise SystemExit(main())
