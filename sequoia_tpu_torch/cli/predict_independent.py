"""Independent-cohort 5-fold ensemble inference.

Counterpart of ``sequoia_tpu/cli/predict_independent.py`` (reference
``evaluation/predict_independent_dataset.py`` contract, its shipped bugs
fixed; writes ``{save_dir}/{exp_name}/test_results.pkl``)::

    python -m sequoia_tpu_torch.cli.predict_independent --ref_file cohort.csv \\
        --feature_path features --checkpoint_template folds/model_best_{fold}.pt

It runs on CUDA unless ``--device cpu`` is given, and raises without CUDA.
Where it differs from the JAX CLI: ``--device`` is new, and a template that
names hub repos (the default ``gevaertlab/sequoia-{cancer}`` from
``--tcga_project``) raises instead of downloading: give a local ``{fold}``
path to ``.pt`` files or downloaded snapshot directories.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sequoia_tpu_torch.data import dataset as ds
from sequoia_tpu_torch.evaluation.predict_independent import predict_independent


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Pretrained-ensemble inference (PyTorch/CUDA)")
    p.add_argument("--ref_file", type=str, required=True)
    p.add_argument("--feature_path", type=str, default="")
    p.add_argument("--feature_use", type=str, default="cluster_features")
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--num-heads", dest="num_heads", type=int, default=16)
    p.add_argument("--tcga_project", default=None, type=str)
    p.add_argument("--save_dir", type=str, default="")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--checkpoint_template", type=str, default=None,
                   help="'{fold}'-templated local path (.pt files or hub-layout snapshot "
                        "directories); default gevaertlab/sequoia-{cancer} from "
                        "--tcga_project, which the port does not download")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import pandas as pd

    np.random.seed(args.seed)
    save_dir = os.path.join(args.save_dir, args.exp_name)

    df = pd.read_csv(args.ref_file)
    df = ds.filter_no_features(df, args.feature_path, args.feature_use)
    if "tcga_project" in df.columns and args.tcga_project:
        df = df[df["tcga_project"].isin([args.tcga_project])].reset_index(drop=True)

    template = args.checkpoint_template
    if template is None:
        if not args.tcga_project:
            raise SystemExit("need --checkpoint_template or --tcga_project (to resolve the "
                             "gevaertlab/sequoia-{cancer} HF checkpoints)")
        cancer = args.tcga_project.split("-")[-1].lower()
        template = f"gevaertlab/sequoia-{cancer}"

    return predict_independent(
        df, args.feature_path, save_dir, checkpoint_template=template, folds=args.folds,
        feature_use=args.feature_use, batch_size=args.batch_size, depth=args.depth,
        num_heads=args.num_heads, seed=args.seed,
        device=None if args.device == "cuda" else args.device)


if __name__ == "__main__":
    main()
