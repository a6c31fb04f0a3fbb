"""Spatial expression-map CLI: one slide -> ``stride-{stride}.csv``.

Counterpart of ``sequoia_tpu/cli/visualize.py`` (reference
``spatial_vis/visualize.py``; the same flags and output,
``visualizations/{project}/{save_folder}/{wsi_file_name}/stride-{stride}.csv``)::

    python -m sequoia_tpu_torch.cli.visualize --study brca --project TCGA-BRCA \\
        --wsi_file_name TCGA-XX-0001.svs --save_folder maps --model_type vis \\
        --feat_type resnet --weights resnet50.pth --gene_names TP53,EGFR

The project layouts (TCGA, spatial_GBM_pred, Breast-ST) follow the
reference's path conventions under ``--data_root``, with its magnification
overrides (the spot diameter's um/px for spatial GBM, the metadata's
magnification for Breast-ST).  The fold checkpoints are
``{checkpoint_dir}/model_best_{fold}.pt`` (``model_best.pt`` for fold 0 of a
ViS or ViT, ``model_{fold}.pt`` for HE2RNA); ViS folds of one architecture
run as one stacked predictor.

It runs on CUDA unless ``--device cpu`` is given, and raises without CUDA.
Where it differs from the JAX CLI: on CUDA the ResNet tile features go
through K4 in every stage, in f32 and bf16 (``cli.serve``'s kernel choice;
``--kernels off`` runs the plain PyTorch versions, and a stderr line names
the set and the stages);
``--device``, ``--kernels`` and ``--compute_dtype`` (the backbone's; float32
by default, as the JAX CLI) are new.  The window stage runs ``vis.apply``
batched over windows, as JAX does: K1 takes one slide at a time and is not
on it.

``--data_parallel`` splits the tile batches over this process's devices
and the window stage over them too (``spatial`` with the extractor's
mesh, sums on the first device); as in JAX it needs ViS folds of one
architecture and device accumulation, and refuses otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np

from sequoia_tpu_torch.cli.compute_features import kernels_line
from sequoia_tpu_torch.cli.serve import build_extractor, serving_kernels
from sequoia_tpu_torch.data.wsi import open_slide
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.pipeline import spatial
from sequoia_tpu_torch.pipeline.features import FEAT_TYPES
from sequoia_tpu_torch.train import checkpoint
from sequoia_tpu_torch.utils.device import resolve_device, tree_to


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Spatial gene-expression maps (PyTorch/CUDA)")
    p.add_argument("--study", type=str, required=True)
    p.add_argument("--project", type=str, required=True)
    p.add_argument("--gene_names", type=str, default="all",
                   help='comma-separated genes, a .npy of names, or "all"')
    p.add_argument("--wsi_file_name", type=str, required=True)
    p.add_argument("--save_folder", type=str, required=True)
    p.add_argument("--model_type", type=str, required=True, choices=["he2rna", "vit", "vis"])
    p.add_argument("--feat_type", type=str, required=True, choices=list(FEAT_TYPES))
    p.add_argument("--folds", type=str, default="0,1,2,3,4")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--data_root", type=str, default=".")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="default {model_type}_{feat_type}/{study}/")
    p.add_argument("--weights", type=str, required=True,
                   help="backbone weights (.pt/.bin) or 'random'")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--accumulate", type=str, default="auto",
                   choices=["auto", "host", "device"],
                   help="overlap-averaging sums: host float64 (the reference's) or f32 on "
                        "the device; auto = device for stacked vis folds at >= 1024 genes")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="the backbone's compute dtype")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    p.add_argument("--kernels", default="on", choices=["on", "off"],
                   help="ResNet tiles through the K4 kernel (on) or the plain PyTorch versions")
    p.add_argument("--data_parallel", action="store_true",
                   help="split tile batches and windows over this process's devices "
                        "(vis folds of one architecture, device accumulation)")
    return p


def resolve_paths(args):
    """The reference's path conventions per project kind -> (slide path,
    mask, manual resize factor or None)."""
    root = args.data_root
    wsi = args.wsi_file_name
    if "TCGA" in wsi:
        slide_path = os.path.join(root, "TCGA", args.project, wsi)
        mask = np.load(os.path.join(root, "TCGA", args.project + "_Masks",
                                    wsi.replace(".svs", ""), "mask.npy"))
        return slide_path, mask, None
    if args.project == "spatial_GBM_pred":
        import pandas as pd

        slide_path = os.path.join(root, "Spatial_GBM", "pyramid", wsi)
        mask = np.load(os.path.join(root, "Spatial_GBM", "masks", wsi.replace(".tif", ".npy")))
        px_df = pd.read_csv(os.path.join(root, "Spatial_Heiland", "data", "classify",
                                         "spot_diameter.csv"))
        diam = px_df[px_df["slide_id"] == wsi.split("_")[1] + "_T"]["pixel_diameter"].values[0]
        um_px = 55 / diam
        return slide_path, mask, 0.5 / um_px
    if args.project == "Breast-ST":
        slide_path = os.path.join(root, "Breast-ST", "wsis", wsi)
        mask = np.load(os.path.join(root, "Breast-ST", "masks", wsi.replace(".tif", ".npy")))
        with open(os.path.join(root, "Breast-ST", "metadata",
                               wsi.replace(".tif", ".json"))) as f:
            meta = json.load(f)
        mag = float(str(meta["magnification"]).replace("x", ""))
        return slide_path, mask, mag / 20.0
    raise SystemExit("unknown project layout; expected TCGA wsi name, spatial_GBM_pred, "
                     "or Breast-ST")


def fold_checkpoint(ckpt_dir: str, fold: int, model_type: str) -> str:
    """The fold's file: ``model_best_{fold}.pt``, ``model_best.pt`` for a
    ViS or ViT fold 0 without it, ``model_{fold}.pt`` for HE2RNA (only the
    basename is rewritten)."""
    ckpt = os.path.join(ckpt_dir, f"model_best_{fold}.pt")
    if fold == 0 and model_type in ("vit", "vis") and not os.path.exists(ckpt):
        ckpt = os.path.join(ckpt_dir, "model_best.pt")
    if model_type == "he2rna":
        d, b = os.path.split(ckpt)
        ckpt = os.path.join(d, b.replace("best_", ""))
    return ckpt


def load_fold_predictors(ckpt_dir: str, folds: list[int], model_type: str, device,
                         mesh=None):
    """``(fold_models, num_tokens)``: one stacked predictor for ViS folds of
    one architecture (sharded over ``mesh`` when given), else ``{fold:
    predict_fn}``; the token budget of the windows is the models'
    ``num_clusters`` (100 for HE2RNA)."""
    fold_models, vis_cfg, vis_params, cfg = {}, None, {}, None
    for fold in folds:
        sd = checkpoint.load_torch_checkpoint(fold_checkpoint(ckpt_dir, fold, model_type))
        if model_type == "vis":
            cfg, params = convert.vis_from_torch(sd)
            params = tree_to(params, device)
            if vis_cfg in (None, cfg):
                vis_cfg, vis_params[fold] = cfg, params
            fold_models[fold] = spatial.make_vis_predict_fn(cfg, params)
        elif model_type == "vit":
            cfg, params = convert.vit_from_torch(sd)
            fold_models[fold] = spatial.make_vit_predict_fn(cfg, tree_to(params, device))
        else:
            cfg, params = convert.he2rna_from_torch(sd)
            fold_models[fold] = spatial.make_he2rna_predict_fn(cfg, tree_to(params, device))
    if model_type == "vis" and len(vis_params) == len(folds):
        fold_models = spatial.make_vis_stacked_predict_fn(vis_cfg, vis_params, mesh=mesh)
    elif mesh is not None:
        raise SystemExit("--data_parallel needs homogeneous vis folds")
    num_tokens = (vis_cfg.num_clusters if vis_cfg is not None
                  else getattr(cfg, "num_clusters", 100))
    return fold_models, num_tokens


def main(argv=None):
    """Run the CLI; returns the result frame."""
    args = build_parser().parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    ckpt_dir = args.checkpoint_dir or f"{args.model_type}_{args.feat_type}/{args.study}/"

    with open(os.path.join(ckpt_dir, "test_results.pkl"), "rb") as f:
        gene_ids = pickle.load(f)["genes"]
    if args.gene_names == "all":
        gene_names = gene_ids
    elif args.gene_names.endswith(".npy"):
        gene_names = [str(g) for g in np.load(args.gene_names, allow_pickle=True)]
    else:
        gene_names = args.gene_names.split(",")

    slide_path, mask, manual_resize = resolve_paths(args)
    slide = open_slide(slide_path)
    on, _ = serving_kernels(device, [], ("bottleneck_chain",) if args.kernels == "on" else ())
    extractor = build_extractor(args.feat_type, args.weights, on, device=device,
                                batch_size=args.batch_size, compute_dtype=args.compute_dtype,
                                data_parallel=args.data_parallel)
    mesh = getattr(extractor, "mesh", None)
    if mesh is not None and args.model_type != "vis":
        raise SystemExit("--data_parallel window sharding needs vis fold checkpoints "
                         "(the stacked predictor)")
    if mesh is not None and args.accumulate == "host":
        # refused rather than switching an explicit float64 host sum to f32
        raise SystemExit("--data_parallel requires device accumulation; drop --accumulate "
                         "host (or --data_parallel)")
    print(f"visualize: {device.type}"
          + (f" x{mesh.shape['data']} (data parallel)" if mesh else "")
          + ", kernels: " + kernels_line(on), file=sys.stderr)

    folds = [int(i) for i in args.folds.split(",")]
    fold_models, num_tokens = load_fold_predictors(ckpt_dir, folds, args.model_type,
                                                   getattr(extractor, "device", device),
                                                   mesh=mesh)

    save_path = os.path.join("visualizations", args.project, args.save_folder,
                             args.wsi_file_name)
    # the reference resizes every tile before the backbone: Resize(224) for
    # uni, the square patch size for resnet (its Resize((256, 265)) is a typo);
    # Virchow2's bicubic Resize(224) is its extractor's own (extract_from_uint8),
    # as the tile stage resizes with the bilinear filter
    resize_to = {"resnet": args.patch_size, "uni": 224}.get(args.feat_type)
    res = spatial.run_visualize(slide, mask, list(gene_ids), fold_models, extractor,
                                gene_names=gene_names, patch_size=args.patch_size,
                                resize_factor=manual_resize, stride=args.stride,
                                save_path=save_path, resize_patch_to=resize_to,
                                accumulate="device" if mesh is not None else args.accumulate,
                                num_tokens=num_tokens, mesh=mesh)
    print("Done")
    return res


if __name__ == "__main__":
    main()
