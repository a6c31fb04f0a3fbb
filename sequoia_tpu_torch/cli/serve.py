"""One-shot slide serving CLI: slide file(s) -> gene-panel CSV, or a resident
HTTP server.

Counterpart of ``sequoia_tpu/cli/serve.py``: tiling, feature extraction,
k-means and the fold-ensembled aggregator (``--model_type vis|vit|he2rna``)
in one process, the decode thread overlapping the device
(``SlidePredictor.predict_slides``).

    python -m sequoia_tpu_torch.cli.serve \\
        --wsi slide1.svs slide2.svs --checkpoints saved_exp/brca/exp_vis \\
        --weights resnet50.pth --panel TP53,EGFR --out predictions.csv
    python -m sequoia_tpu_torch.cli.serve --http 8000 --checkpoints DIR --weights random

``--checkpoints`` takes a CV output directory (``model_best_{i}.pt``, or
HE2RNA's ``model_{i}.pt``, and ``test_results.pkl``, folds found by name), a
single ``.pt``, or a local HF-layout directory (``config.json`` and
``model.safetensors`` or ``pytorch_model.bin``; ViS folds only, as in JAX).  It runs on CUDA unless ``--device cpu`` is given,
and raises without CUDA.

Where the port differs from the JAX CLI:

* on CUDA it serves with the kernel set of :func:`build_predictor` (K4 in
  every ResNet stage, with ``--feat_type resnet``; K5 for k-means; K1 for
  ViS folds where ``cuda_vis.kernel_takes`` accepts their config, which
  UNI's 1024-d and Virchow2's 2560-d folds do not, and never for ViT or
  HE2RNA folds) and prints
  one stderr line naming it and why K1 was left out; ``--kernels off`` or
  ``--device cpu`` serves with the plain PyTorch versions, but for the
  ViTs' attention (``vit_attention``), which runs wherever its input is a
  CUDA bf16 tensor of a shape it takes (``ops/cuda_vit.takes``);
* ``--compute_dtype`` also sets the ViS and ViT folds' compute dtype (the
  JAX CLI serves them in f32 whatever the flag; ``--compute_dtype float32``
  gives its numerics); HE2RNA folds run in f32;
* ``--compilation_cache`` is accepted and unused;
* no pandas: the gene lists and the CSV go through the ``csv`` module.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import glob
import os
import pickle
import sys
import time

import numpy as np

from sequoia_tpu_torch.cli import add_compile_cache_arg, add_fleet_args
from sequoia_tpu_torch.cli.compute_features import K4_STAGES, load_extractor
from sequoia_tpu_torch.models import convert, he2rna, vis, vit
from sequoia_tpu_torch.ops import cuda_vis
from sequoia_tpu_torch.ops.nn import compute_dtype as to_dtype
from sequoia_tpu_torch.pipeline.features import FEAT_TYPES
from sequoia_tpu_torch.serve import SlidePredictor
from sequoia_tpu_torch.train import checkpoint
from sequoia_tpu_torch.utils.device import resolve_device

#: the kernels the serving entry points run on CUDA: K4 in every ResNet
#: stage (``fused_stages=(1, 2, 3, 4)``; the ResNet backbone only), K5 for
#: every Lloyd step, K1 for the ViS folds' blocks.  ``lloyd_stats`` selects
#: k-means' kernels, K5 and the kmeans++ seeding's ``kmeans_seed``
SERVING_KERNELS = ("bottleneck_chain", "lloyd_stats", "vis_blocks_fused")

#: each aggregator's state-dict converter and panel slicer
_FROM_TORCH = {"vis": convert.vis_from_torch, "vit": convert.vit_from_torch,
               "he2rna": convert.he2rna_from_torch}
_SLICERS = {"vis": vis.slice_head, "vit": vit.slice_head, "he2rna": he2rna.slice_head}


def load_fold_models(path: str, model_type: str = "vis") -> list[tuple[object, dict]]:
    """CV directory / single ``.pt`` / HF-layout directory -> ``[(cfg,
    params), ...]`` (f32, on the CPU).  A ViS or ViT CV directory holds
    ``model_best_{i}.pt``, an HE2RNA one ``model_{i}.pt`` (the reference's
    whole-module saves); the HF layout is ViS-only."""
    from_torch = _FROM_TORCH[model_type]
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "config.json")):  # HF layout
            if model_type != "vis":
                raise SystemExit(f"HF-layout loading is vis-only (got {model_type})")
            return [convert.vis_from_torch(checkpoint.load_hf_vis_state_dict(path))]
        pts = (sorted(glob.glob(os.path.join(path, "model_best*.pt")))
               or sorted(glob.glob(os.path.join(path, "model_*.pt"))))
        if not pts:
            raise SystemExit(f"no model_best*.pt / model_*.pt under {path}")
        return [from_torch(checkpoint.load_torch_checkpoint(p)) for p in pts]
    return [from_torch(checkpoint.load_torch_checkpoint(path))]


def n_outputs(cfg) -> int:
    """A fold config's head width (HE2RNA names it ``output_dim``)."""
    return getattr(cfg, "num_outputs", None) or cfg.output_dim


def input_width(cfg) -> int:
    """The feature width a fold config takes (the ViT names it ``dim``)."""
    return getattr(cfg, "input_dim", None) or cfg.dim


def read_gene_list_file(path: str) -> list[str]:
    """Gene-list file -> names: a ``.npy`` array, a ``.csv``'s last column
    (with a header row, like ``examples/gene_list.csv``), or one name a line."""
    if path.endswith(".npy"):
        return [str(g) for g in np.load(path, allow_pickle=True)]
    if path.endswith(".csv"):
        with open(path, newline="") as f:
            rows = [r for r in csv.reader(f) if r]
        return [r[-1] for r in rows[1:]]
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _gene_list_arg(arg: str, flag: str) -> list[str]:
    """A ``--gene_names``/``--panel`` value: an existing file, or a comma
    list; a value that looks like a file and does not exist stops."""
    if os.path.exists(arg):
        return read_gene_list_file(arg)
    if arg.endswith((".csv", ".npy", ".txt")) or os.sep in arg:
        raise SystemExit(f"{flag} file not found: {arg}")
    return arg.split(",")


def load_gene_names(arg: str | None, ckpt_path: str, n: int) -> list[str]:
    if arg:
        return _gene_list_arg(arg, "--gene_names")
    tr = os.path.join(ckpt_path, "test_results.pkl")
    if os.path.isdir(ckpt_path) and os.path.exists(tr):
        with open(tr, "rb") as f:
            return [str(g) for g in pickle.load(f)["genes"]]
    return [f"gene_{i}" for i in range(n)]


def resolve_panel(arg: str, genes: list[str]) -> tuple[list[int], list[str]]:
    """``--panel`` value -> (head column indices, panel gene names)."""
    wanted = _gene_list_arg(arg, "--panel")
    pos = {g: i for i, g in enumerate(genes)}
    missing = [g for g in wanted if g not in pos]
    if missing:
        raise SystemExit(f"--panel genes not in the model's gene list: "
                         f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
    if not wanted:
        raise SystemExit("--panel resolved to an empty gene list")
    return [pos[g] for g in wanted], wanted


def serving_kernels(device, models, kernels=SERVING_KERNELS,
                    model_type: str = "vis") -> tuple[list[str], str]:
    """The kernel set to serve ``models`` with: the named kernels (a subset
    of :data:`SERVING_KERNELS`) on a CUDA device, K1 only for ViS folds and
    where ``cuda_vis.kernel_takes`` accepts every fold's config; none on
    another device.  Returns ``(kernels, why K1 was left out or "")``."""
    unknown = set(kernels) - set(SERVING_KERNELS)
    if unknown:
        raise ValueError(f"kernels: {sorted(unknown)} are not serving kernels "
                         f"{SERVING_KERNELS}")
    if resolve_device(device).type != "cuda":
        return [], ""
    on = [k for k in SERVING_KERNELS if k in kernels]
    if "vis_blocks_fused" in on and model_type != "vis":
        on.remove("vis_blocks_fused")
        return on, f"{model_type} folds have no ViS blocks"
    if "vis_blocks_fused" in on:
        for cfg, _ in models:
            takes, why = cuda_vis.kernel_takes(cfg, to_dtype(cfg.compute_dtype))
            if not takes:
                on.remove("vis_blocks_fused")
                return on, why
    return on, ""


def build_extractor(feat_type: str, weights: str, on: list[str], *, device,
                    batch_size: int, compute_dtype: str, data_parallel: bool = False,
                    devices=None):
    """The backbone of :func:`build_predictor`: K4 in every ResNet stage where
    ``bottleneck_chain`` is in ``on`` (removed from ``on`` for the ViTs); data
    parallel over ``devices`` (default: this process's) with
    ``data_parallel``."""
    if feat_type != "resnet" and "bottleneck_chain" in on:
        on.remove("bottleneck_chain")
    kw = {"devices": devices} if devices is not None else {}
    return load_extractor(feat_type, weights, batch_size, compute_dtype, data_parallel,
                          device=device, fused_stages=K4_STAGES if "bottleneck_chain" in on
                          else (), **kw)


def build_predictor(feat_type: str, weights: str, models, *, device=None,
                    kernels=SERVING_KERNELS, batch_size: int = 128,
                    compute_dtype: str = "bfloat16", n_clusters: int = 100,
                    max_patches: int = 4000, patch_size: int = 256,
                    model_type: str = "vis", data_parallel: bool = False, devices=None):
    """The serving predictor with the kernel set of :func:`serving_kernels`,
    less the ResNet kernel K4 for the ViT backbones and K1 for ViT and
    HE2RNA folds.  Returns ``(SlidePredictor, line)``, the line naming the
    kernels it serves with and, where K1 is left out, why.  No kernel
    failure is caught.  ``data_parallel``: the backbone over ``devices``
    (default: this process's), k-means and the folds on the first."""
    dev = resolve_device(device)
    on, why = serving_kernels(dev, models, kernels, model_type)
    extractor = build_extractor(feat_type, weights, on, device=dev, batch_size=batch_size,
                                compute_dtype=compute_dtype, data_parallel=data_parallel,
                                devices=devices)
    dev = getattr(extractor, "device", dev)
    pred = SlidePredictor(extractor, models, model_type=model_type, n_clusters=n_clusters,
                          max_patches=max_patches, patch_size=patch_size,
                          use_pallas_kmeans="lloyd_stats" in on,
                          use_fused_vis="vis_blocks_fused" in on, device=dev)
    mesh = getattr(extractor, "mesh", None)
    line = (f"serve: {dev.type}"
            + (f" x{mesh.shape['data']} (data parallel)" if mesh else "")
            + ", kernels: " + (", ".join(on + ["kmeans_seed"] * ("lloyd_stats" in on))
                               or "none (plain PyTorch)")
            + (f"; vis_blocks_fused left out: {why}" if why else ""))
    return pred, line


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="WSI -> gene panel serving (PyTorch/CUDA)")
    p.add_argument("--wsi", type=str, nargs="+", default=None,
                   help="slides for a one-shot run (omit with --http)")
    p.add_argument("--http", type=str, default=None, metavar="[HOST:]PORT",
                   help="stay resident and serve over HTTP: POST /predict "
                        "{'wsi': path|[paths]}, GET /genes, GET /healthz")
    p.add_argument("--http_max_pending", type=int, default=256,
                   help="cap on admitted-but-unfinished slides under --http; past it "
                        "POST /predict returns 429")
    p.add_argument("--http_timeout", type=float, default=None,
                   help="per-request wait bound in seconds under --http (504 on expiry)")
    p.add_argument("--checkpoints", type=str, required=True,
                   help="CV dir, .pt file, or HF-layout dir")
    p.add_argument("--feat_type", default="resnet", choices=list(FEAT_TYPES),
                   help="backbone: ResNet-50 (2048-d), UNI ViT-L/16 (1024-d) or Virchow2 "
                        "ViT-H/14 (2560-d)")
    p.add_argument("--model_type", default="vis", choices=["vis", "vit", "he2rna"],
                   help="aggregator family of the checkpoints")
    p.add_argument("--weights", type=str, required=True,
                   help='backbone weights (.pt/.bin) or "random"')
    p.add_argument("--gene_names", type=str, default=None,
                   help="gene_list.csv / .npy / comma list; default: the checkpoint "
                        "dir's test_results.pkl")
    p.add_argument("--panel", type=str, default=None,
                   help="restrict the output to a gene panel (comma list, or a .csv "
                        "with a header row / .npy / .txt); slices the model head")
    p.add_argument("--out", type=str, default="predictions.csv")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--max_patches", type=int, default=4000)
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--num_clusters", type=int, default=100)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    p.add_argument("--kernels", default="on", choices=["on", "off"],
                   help="serve with the CUDA kernels (on) or the plain PyTorch versions")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of the one-shot run into DIR "
                        "(trace.json) and, beside it, spans.json: the program's spans "
                        "(serve.slide, serve.kmeans, kmeans.seed, ...) and counters "
                        "(kmeans.lloyd_steps, host_syncs), summed and one record each")
    p.add_argument("--data_parallel", action="store_true",
                   help="split backbone patch batches over this process's devices")
    add_compile_cache_arg(p)
    add_fleet_args(p)
    return p


def _write_csv(path: str, genes: list[str], rows: dict) -> None:
    """One row per slide, one column per gene, ``wsi_file_name`` the index
    name: the JAX CLI's ``DataFrame(rows, index=genes).T.to_csv`` layout."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["wsi_file_name", *genes])
        for name, vals in rows.items():
            w.writerow([name, *(repr(float(v)) for v in vals)])


def main(argv=None) -> dict | None:
    """Run the CLI; a one-shot run returns ``{"slides", "failed",
    "serve_seconds", "out"}`` (``serve_seconds``: the ``predict_slides``
    loop, host clock)."""
    args = build_parser().parse_args(argv)
    if not args.wsi and not args.http:
        raise SystemExit("need --wsi (one-shot) or --http (resident server)")
    if args.wsi and args.http:
        raise SystemExit("--wsi and --http are mutually exclusive (the resident server "
                         "takes slides via POST /predict)")
    device = resolve_device(None if args.device == "cuda" else args.device)
    if args.multihost:
        # bulk scoring across a fleet: each rank serves its contiguous shard of
        # the slide list and writes {out}.part{rank}
        if args.http:
            raise SystemExit("--multihost shards one-shot bulk scoring; run one --http "
                             "server per host instead")
        from sequoia_tpu_torch.parallel import multihost

        args.wsi = list(multihost.fleet_shard_rows(args.wsi, args))
        device = multihost.fleet_device(args, device)
        root, ext = os.path.splitext(args.out)
        args.out = f"{root}.part{multihost.process_index()}{ext}"
        if not args.wsi:
            print("[multihost] empty shard; nothing to do")
            return None
    models = load_fold_models(args.checkpoints, args.model_type)
    width = n_outputs(models[0][0])
    genes = load_gene_names(args.gene_names, args.checkpoints, width)
    if len(genes) != width:
        raise SystemExit(f"{len(genes)} gene names vs model head {width}")
    if args.panel:
        idx, genes = resolve_panel(args.panel, genes)
        slicer = _SLICERS[args.model_type]
        models = [slicer(cfg, params, idx) for cfg, params in models]
    cfg0 = models[0][0]
    # HE2RNA has no position embedding: any token count serves
    if getattr(cfg0, "num_clusters", args.num_clusters) != args.num_clusters:
        raise SystemExit(f"--num_clusters {args.num_clusters} != checkpoint num_clusters "
                         f"{cfg0.num_clusters} (inferred from pos_emb)")
    if args.model_type != "he2rna":
        fold_dtype = None if args.compute_dtype == "float32" else args.compute_dtype
        models = [(dataclasses.replace(cfg, compute_dtype=fold_dtype), p) for cfg, p in models]

    pred, line = build_predictor(
        args.feat_type, args.weights, models, device=device,
        kernels=SERVING_KERNELS if args.kernels == "on" else (), batch_size=args.batch_size,
        compute_dtype=args.compute_dtype, n_clusters=args.num_clusters,
        max_patches=args.max_patches, patch_size=args.patch_size, model_type=args.model_type,
        data_parallel=args.data_parallel)
    if input_width(cfg0) != pred.extractor.feature_dim:
        raise SystemExit(f"--feat_type {args.feat_type} produces "
                         f"{pred.extractor.feature_dim}-d features but the checkpoint "
                         f"expects input_dim {input_width(cfg0)}")
    print(line, file=sys.stderr)

    if args.http:
        from sequoia_tpu_torch import http_serve

        if args.profile:
            print("--profile applies to one-shot runs only; ignored under --http",
                  file=sys.stderr)
        host, _, port = args.http.rpartition(":")
        try:
            port_n = int(port)
        except ValueError:
            raise SystemExit(f"--http expects [HOST:]PORT, got {args.http!r}") from None
        http_serve.run(http_serve.PredictorService(
            pred, genes, max_pending_slides=args.http_max_pending,
            request_timeout=args.http_timeout), host or "127.0.0.1", port_n)
        return None

    if len(set(args.wsi)) != len(args.wsi):
        # a duplicated path would run the pipeline twice and collapse to one row
        print("serve: dropping duplicate --wsi paths", file=sys.stderr)
        args.wsi = list(dict.fromkeys(args.wsi))
    names = [os.path.basename(p) for p in args.wsi]
    if len(set(names)) != len(names):  # disambiguate duplicate basenames
        names = list(args.wsi)
    name_of = dict(zip(args.wsi, names))
    rows = {}
    failed = 0

    def quarantine(path, e):  # skip the slide, as the reference does
        nonlocal failed
        failed += 1
        print(f"{name_of[path]}: {e}", file=sys.stderr)

    from sequoia_tpu_torch.utils.profiling import device_trace

    t0 = time.perf_counter()
    with device_trace(args.profile):
        # cross-slide pipelining: slide i+1 decodes while slide i computes
        for path, out in pred.predict_slides(args.wsi, on_error=quarantine):
            rows[name_of[path]] = out[0]
            print(f"{name_of[path]}: ok ({len(models)}-fold ensemble)")
    seconds = time.perf_counter() - t0
    if not rows:
        raise SystemExit(f"all {failed} slides failed; nothing written")
    _write_csv(args.out, genes, rows)
    print(f"wrote {args.out} ({len(rows)} slides x {len(genes)} genes"
          + (f"; {failed} failed)" if failed else ")"))
    return {"slides": len(rows), "failed": failed, "serve_seconds": seconds, "out": args.out}


if __name__ == "__main__":
    main()
