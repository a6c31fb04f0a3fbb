"""GTEx pretraining of the ViS, ViT or HE2RNA: the train-only phase.

Counterpart of ``sequoia_tpu/cli/pretrain_gtex.py`` (reference
``src/pretrain_gtex.py``): AdamW at lr 3e-3 for vis/vit, Adam at lr 3e-3 for
he2rna, a date-stamped experiment name, ``--quick`` (20 slides, 5 epochs);
writes ``{save_dir}/{date}_{exp_name}/model_best.pt`` (``model.pt`` for
he2rna).  It runs on CUDA unless ``--device cpu`` is given;
``--compilation_cache`` is accepted and unused.
"""

from __future__ import annotations

import argparse
import datetime
import functools
import os

import numpy as np
import torch

from sequoia_tpu_torch.cli import add_compile_cache_arg
from sequoia_tpu_torch.data import dataset as ds
from sequoia_tpu_torch.models import convert, he2rna
from sequoia_tpu_torch.train import checkpoint, cv, he2rna_fit, loop
from sequoia_tpu_torch.utils.device import resolve_device
from sequoia_tpu_torch.utils.logging import make_log_fn


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GTEx pretraining (PyTorch/CUDA)")
    p.add_argument("--save_dir", type=str, default="pretrained_model")
    p.add_argument("--path_csv", type=str, required=True)
    p.add_argument("--feature_path", type=str, default="features")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--log", type=str, default=None, help="wandb project")
    p.add_argument("--model", type=str, default="vis", choices=["vis", "vit", "he2rna"])
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--num_epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--n_workers", type=int, default=8, help="(accepted for compatibility)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--quick", type=int, default=0)
    add_compile_cache_arg(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    return p


def main(argv=None) -> str:
    """Returns the path of the written ``model_best.pt`` (``model.pt``)."""
    args = build_parser().parse_args(argv)
    import pandas as pd

    dev = resolve_device(None if args.device == "cuda" else args.device)
    np.random.seed(args.seed)

    stamp = "{date:%Y-%m-%d}".format(date=datetime.datetime.now())
    args.exp_name = stamp if args.exp_name == "" else f"{stamp}_{args.exp_name}"
    save_dir = os.path.join(args.save_dir, args.exp_name)
    os.makedirs(save_dir, exist_ok=True)
    log_fn, finish = make_log_fn(args.log, config=vars(args), name=args.exp_name)

    df = pd.read_csv(args.path_csv)
    df = ds.filter_no_features(df, args.feature_path, "cluster_features")
    if args.quick:
        df = df.iloc[0:20, :]
        args.num_epochs = 5

    dataset = ds.FeatureDataset(df, args.feature_path)
    loader = ds.BatchLoader(dataset, args.batch_size, shuffle=True, seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.model in ("vis", "vit"):
        cfg, params, apply_fn, to_torch, from_torch = cv.build_model(
            args.model, dataset.num_genes, dataset.feature_dim, gen,
            num_clusters=getattr(dataset, "num_tokens", None) or 100)
        if args.checkpoint:
            cfg, params = from_torch(checkpoint.load_torch_checkpoint(args.checkpoint), cfg)
        save_path = os.path.join(save_dir, "model_best.pt")
        loop.train(apply_fn, params, functools.partial(loop.make_adamw, lr=3e-3),
                   {"train": loader}, num_epochs=args.num_epochs, phases=("train",),
                   log_fn=log_fn, device=dev,
                   save_fn=lambda p: checkpoint.save_torch_state_dict(to_torch(cfg, p),
                                                                      save_path))
    else:
        cfg = he2rna.HE2RNAConfig(
            input_dim=dataset.feature_dim, output_dim=dataset.num_genes, layers=(256, 256),
            ks=he2rna.ks_for_tokens(getattr(dataset, "num_tokens", None)))
        params = he2rna.init(cfg, gen)
        if args.checkpoint:
            # the architecture from the state dict, as train/cv.py's he2rna branch
            cfg, params = convert.he2rna_from_torch(
                checkpoint.load_torch_checkpoint(args.checkpoint))
        save_path = os.path.join(save_dir, "model.pt")
        he2rna_fit.fit(cfg, params, 3e-3, loader, None, None, max_epochs=args.num_epochs,
                       seed=args.seed, log_fn=log_fn, device=dev,
                       save_fn=lambda p: checkpoint.save_torch_state_dict(
                           convert.he2rna_to_torch(cfg, p), save_path))
    finish()
    print("Finished pre-training")
    return save_path


if __name__ == "__main__":
    main()
