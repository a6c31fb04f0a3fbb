"""The host syncs of one slide of each serving path, counted two ways on the
card: by ``torch.cuda.set_sync_debug_mode("warn")``, which warns at every
call that makes the host wait for the device, and by the program's own
``host_syncs`` counter (``utils/profiling.count``).  Each path runs one slide
with tracing off and one under a ``torch.profiler`` session (the counter
counts then); the two warning counts and the counter must agree.

Paths: ``features`` (``predict_features`` of host (N, 2048) features, K5
and K1), ``vit`` and ``he2rna`` (the same through ViT and HE2RNA folds, K5),
``resnet``, ``uni`` and ``virchow2`` (``predict_patches`` of host uint8
patches; K4 for ResNet), ``wsi_rgb`` and ``wsi_screened`` (``predict_wsi`` of an in-memory
slide at AppMag 20 and 40; the second resizes with Pillow and is left out
without it).  :func:`slides` serves further readers through ``predict_wsi``
too (``chip_smoke.py`` phase 15 adds the raw-plane modes, ``ycbcr`` and
``mosaic``, from its stand-in for a JPEG-tiled slide).  The predictors are
the serve CLI's (``cli.serve.build_predictor``) on random weights.  One JSON
line a path, with the slide's mode, the file and line of each warning, and a
last line ``{"agree": ...}``; the exit code is 1 where a path disagrees.

    python -m sequoia_tpu_torch.tools.sync_census [--paths features,resnet,...]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import warnings

import numpy as np
import torch

from sequoia_tpu_torch.data.wsi import ArrayReader
from sequoia_tpu_torch.models import he2rna, vis, vit
from sequoia_tpu_torch.utils import profiling

PATHS = ("features", "vit", "he2rna", "resnet", "uni", "virchow2", "wsi_rgb", "wsi_screened")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def folds(input_dim: int, n: int = 5, model_type: str = "vis") -> list:
    """``n`` random folds of ``model_type`` at the serving widths, bf16
    blocks for ViS and ViT."""
    if model_type == "vis":
        mod, cfg = vis, vis.ViSConfig(num_outputs=20820, input_dim=input_dim,
                                      compute_dtype="bfloat16")
    elif model_type == "vit":
        mod, cfg = vit, vit.ViTConfig(num_outputs=20820, dim=input_dim,
                                      compute_dtype="bfloat16")
    else:
        mod, cfg = he2rna, he2rna.HE2RNAConfig(input_dim=input_dim, output_dim=20820)
    return [(cfg, mod.init(cfg, torch.Generator().manual_seed(i))) for i in range(n)]


def slide_reader(app_mag: int, side: int = 3072, seed: int = 0) -> ArrayReader:
    """A two-level in-memory slide: pink tissue with dark nuclei on a white
    background, the tissue in the middle two thirds."""
    r = np.random.default_rng(seed)
    img = np.full((side, side, 3), 242, np.uint8)
    lo, hi = side // 6, side - side // 6
    tissue = (np.array([214, 140, 180], np.float32)
              + 18 * r.standard_normal((hi - lo, hi - lo, 1)))
    dots = r.random((hi - lo, hi - lo)) < 0.03
    tissue[dots] -= 80
    img[lo:hi, lo:hi] = np.clip(tissue, 0, 255).astype(np.uint8)
    return ArrayReader([img, img[::16, ::16]], {"aperio.AppMag": str(app_mag)})


def slides(dev, readers=None) -> dict:
    """``{path: (() -> None, mode)}``: one slide of each path, and of each
    ``{path: slide reader}`` of ``readers`` through the ResNet predictor's
    ``predict_wsi``; ``mode`` is the streaming mode ``predict_wsi`` picks
    (``'rgb'``, ``'screened'``, ``'ycbcr'``, ``'mosaic'``), else None."""
    from sequoia_tpu_torch.cli.serve import build_predictor

    rng = np.random.default_rng(0)
    centres = np.maximum(rng.normal(0.3, 0.4, (40, 2048)), 0).astype(np.float32)
    feats = np.maximum(centres[rng.integers(0, 40, 4000)]
                       + 0.2 * rng.standard_normal((4000, 2048)), 0).astype(np.float32)
    u8 = rng.integers(0, 256, (300, 256, 256, 3), dtype=np.uint8)
    resnet, _ = build_predictor("resnet", "random", folds(2048), device=dev)
    uni, _ = build_predictor("uni", "random", folds(1024), device=dev)
    virchow2, _ = build_predictor("virchow2", "random", folds(2560), device=dev)
    out = {"features": (lambda: resnet.predict_features(feats), None)}
    for kind in ("vit", "he2rna"):
        pred, _ = build_predictor("resnet", "random", folds(2048, 2, kind), device=dev,
                                  model_type=kind)
        out[kind] = (lambda p=pred: p.predict_features(feats), None)
    out["resnet"] = (lambda: resnet.predict_patches(u8), None)
    out["uni"] = (lambda: uni.predict_patches(u8[:100]), None)
    out["virchow2"] = (lambda: virchow2.predict_patches(u8[:100]), None)
    wsi = {"wsi_rgb": slide_reader(20)}
    try:
        import PIL  # noqa: F401  (the AppMag 40 path resizes with Pillow)

        wsi["wsi_screened"] = slide_reader(40)
    except ImportError:
        pass
    for name, reader in {**wsi, **(readers or {})}.items():
        mode = resnet._pick_mode(resnet._candidates(reader), False)[0]
        out[name] = (lambda r=reader: resnet.predict_wsi(r), mode)
    return out


def warned(fn) -> tuple[int, dict]:
    """The synchronising calls of ``fn()``: their number and where each was
    made (``file:line`` of the Python frame that called into the library)."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in got if "synchroniz" in str(w.message)]
    where = collections.Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                                for w in syncs)
    return len(syncs), dict(sorted(where.items()))


def census(fn) -> dict:
    """One slide with tracing off, one traced: the warnings of each and the
    traced slide's ``host_syncs``."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up: builds, allocations, first-call checks
    torch.cuda.synchronize()
    off, where = warned(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        profiling.clear()
        on, where_on = warned(fn)
        counted = profiling.summary()["counters"].get("host_syncs", 0)
    profiling.clear()
    return {"syncs_off": off, "syncs_on": on, "host_syncs": counted,
            "agree": off == on == counted, "where": where,
            **({"where_traced": where_on} if where_on != where else {})}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--paths", default=",".join(PATHS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sync_census needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    runs = slides(dev)
    warned(lambda: None)  # the first switch of the mode warns once itself
    agree = True
    for name in args.paths.split(","):
        if name not in runs:
            print(json.dumps({"path": name, "skipped": "not available here"}))
            continue
        fn, mode = runs[name]
        row = census(fn)
        agree &= row["agree"]
        print(json.dumps({"path": name, "mode": mode, **row}), flush=True)
    print(json.dumps({"agree": agree, "device": torch.cuda.get_device_name(dev),
                      "torch": torch.__version__}))
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
