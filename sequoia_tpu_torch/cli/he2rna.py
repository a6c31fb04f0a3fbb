"""HE2RNA baseline 5-fold cross-validation.

Counterpart of ``sequoia_tpu/cli/he2rna.py`` (the reference ``src/he2rna.py``
__main__ contract, the same flags and outputs:
``{destfolder}/{subfolder}/{exp_name}/model_{i}.pt`` and
``test_results.pkl``)::

    python -m sequoia_tpu_torch.cli.he2rna --path_csv ref.csv --feature_path features

It runs on CUDA unless ``--device cpu`` is given, and raises without CUDA.
Where it differs from the JAX CLI: ``--device`` is new;
``--compilation_cache`` is accepted and unused.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sequoia_tpu_torch.cli import add_compile_cache_arg
from sequoia_tpu_torch.data import dataset as ds
from sequoia_tpu_torch.train import cv
from sequoia_tpu_torch.utils.logging import make_log_fn


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HE2RNA 5-fold CV (PyTorch/CUDA)")
    p.add_argument("--path_csv", type=str, required=True)
    p.add_argument("--feature_path", type=str, default="features/")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--change_num_genes", action="store_true")
    p.add_argument("--num_genes", type=int, default=None)
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--log", type=str, default=None)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--num_workers", type=int, default=0, help="(accepted for compatibility)")
    p.add_argument("--tcga_projects", default=None, type=str, nargs="*")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--subfolder", type=str, default="")
    p.add_argument("--destfolder", type=str, default="")
    p.add_argument("--hf_export", action="store_true",
                   help="also write per-fold PyTorchModelHubMixin layout dirs (hf_fold_{i}/) "
                        "for hub publishing")
    add_compile_cache_arg(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import pandas as pd

    np.random.seed(args.seed)
    save_dir = os.path.join(args.destfolder, args.subfolder, args.exp_name)
    os.makedirs(save_dir, exist_ok=True)
    log_fn, finish = make_log_fn(args.log, config=vars(args), name=args.exp_name)

    df = pd.read_csv(args.path_csv)
    if args.tcga_projects:
        df = df[df["tcga_project"].isin(args.tcga_projects)]
    df = ds.filter_no_features(df, args.feature_path, "cluster_features")

    out = cv.run_he2rna_cross_validation(
        df, args.feature_path, save_dir, k=args.k, batch_size=args.batch_size, lr=args.lr,
        seed=args.seed, checkpoint_path=args.checkpoint,
        change_num_genes=args.change_num_genes, num_genes=args.num_genes, log_fn=log_fn,
        hf_export=args.hf_export, device=None if args.device == "cuda" else args.device)
    finish()
    return out


if __name__ == "__main__":
    main()
