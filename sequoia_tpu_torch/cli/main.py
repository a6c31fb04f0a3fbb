"""Train and evaluate the ViS or ViT aggregator with 5-fold patient CV.

Counterpart of ``sequoia_tpu/cli/main.py`` (reference ``src/main.py`` flags,
the same outputs: ``{save_dir}/{cohort}/{exp_name}/model_best_{i}.pt`` and
``test_results.pkl``)::

    python -m sequoia_tpu_torch.cli.main --ref_file ref.csv --feature_path features \\
        --model_type vis --train --save_on loss+corr --stop_on loss+corr

It runs on CUDA unless ``--device cpu`` is given, and raises without CUDA.
Where it differs from the JAX CLI: ``--device`` is new; the JAX
compile-cache flag is gone; ``--mesh`` and the multi-host flags stop at parse
time (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from sequoia_tpu_torch.cli import MULTI_GPU, NotPorted, add_fleet_args
from sequoia_tpu_torch.data import dataset as ds
from sequoia_tpu_torch.train import cv
from sequoia_tpu_torch.utils.logging import make_log_fn


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SEQUOIA 5-fold CV training (PyTorch/CUDA)")
    p.add_argument("--src_path", type=str, default="", help="project path")
    p.add_argument("--ref_file", type=str, required=True, help="path to reference file")
    p.add_argument("--sample-percent", dest="sample_percent", type=float, default=None,
                   help="downsample the ref file to a fraction of rows")
    p.add_argument("--tcga_projects", type=str, default=None,
                   help="comma-separated tcga projects to keep")
    p.add_argument("--feature_path", type=str, default="features/")
    p.add_argument("--save_dir", type=str, default="saved_exp")
    p.add_argument("--hf_export", action="store_true",
                   help="also write per-fold PyTorchModelHubMixin layout dirs "
                        "(hf_fold_{i}/) for hub publishing")
    p.add_argument("--cohort", type=str, default="TCGA")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--filter_no_features", type=int, default=1)
    p.add_argument("--log", type=str, default=None, help="wandb project name")
    p.add_argument("--model_type", type=str, default="vit", choices=["vit", "vis"])
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--num-heads", dest="num_heads", type=int, default=16)
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--train", action="store_true")
    p.add_argument("--num_epochs", type=int, default=200)
    p.add_argument("--change_num_genes", type=int, default=0,
                   help="gene count of the pretraining checkpoint when fine-tuning")
    p.add_argument("--num_genes", type=int, default=None,
                   help="(accepted for compatibility; the reference's main.py never "
                        "reads it: the pretrained width goes in --change_num_genes)")
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--save_on", type=str, default="loss", choices=["loss", "loss+corr"])
    p.add_argument("--stop_on", type=str, default="loss", choices=["loss", "loss+corr"])
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="float32 = the parity path; bfloat16 = bf16 blocks (f32 LN, head "
                        "and AdamW) and host-side bf16 batch casts")
    p.add_argument("--moment_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="AdamW moment storage: float32 = torch.optim.AdamW (parity); "
                        "bfloat16 = the low-memory AdamW (f32 update math)")
    p.add_argument("--resume", action="store_true",
                   help="checkpoint and resume the full training state per fold")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    p.add_argument("--mesh", type=str, default=None, action=NotPorted, item=MULTI_GPU)
    add_fleet_args(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import pandas as pd

    if args.num_genes is not None:
        print("--num_genes is ignored (like the reference's main.py); the pretrained head "
              "width goes in --change_num_genes", file=sys.stderr)
    np.random.seed(args.seed)

    save_dir = os.path.join(args.src_path, args.save_dir, args.cohort, args.exp_name)
    os.makedirs(save_dir, exist_ok=True)
    log_fn, finish = make_log_fn(args.log, config=vars(args), name=args.exp_name)

    df = pd.read_csv(args.ref_file)
    if args.sample_percent is not None:
        df = df.sample(frac=args.sample_percent).reset_index(drop=True)
    if "tcga_project" in df.columns and args.tcga_projects:
        projects = args.tcga_projects.split(",")
        df = df[df["tcga_project"].isin(projects)].reset_index(drop=True)
        print(f"Filtered project {projects}")
    if args.filter_no_features:
        df = ds.filter_no_features(df, args.feature_path, "cluster_features")

    out = cv.run_cross_validation(
        df, args.feature_path, save_dir, model_type=args.model_type,
        depth=args.depth, num_heads=args.num_heads, k=args.k,
        batch_size=args.batch_size, lr=args.lr, num_epochs=args.num_epochs,
        seed=args.seed, save_on=args.save_on, stop_on=args.stop_on,
        do_train=args.train, checkpoint_path=args.checkpoint,
        change_num_genes=args.change_num_genes, log_fn=log_fn, resume=args.resume,
        hf_export=args.hf_export,
        compute_dtype=None if args.compute_dtype == "float32" else args.compute_dtype,
        moment_dtype=None if args.moment_dtype == "float32" else args.moment_dtype,
        device=None if args.device == "cuda" else args.device)
    finish()
    return out


if __name__ == "__main__":
    main()
