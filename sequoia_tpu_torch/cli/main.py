"""Train and evaluate the ViS or ViT aggregator with 5-fold patient CV.

Counterpart of ``sequoia_tpu/cli/main.py`` (reference ``src/main.py`` flags,
the same outputs: ``{save_dir}/{cohort}/{exp_name}/model_best_{i}.pt`` and
``test_results.pkl``)::

    python -m sequoia_tpu_torch.cli.main --ref_file ref.csv --feature_path features \\
        --model_type vis --train --save_on loss+corr --stop_on loss+corr

It runs on CUDA unless ``--device cpu`` is given, and raises without CUDA.
Where it differs from the JAX CLI: ``--device`` is new;
``--compilation_cache`` is accepted and unused.

Several devices: ``--mesh data=N,model=M`` trains over N x M ranks, one per
device (``parallel.multihost``; the gene head splits over ``model``).  From a
plain command the CLI spawns the ranks on this host itself (``cuda:0`` ..
``cuda:NM-1``; with ``--device cpu``, NM CPU processes over gloo; more ranks
than CUDA devices raise); under torchrun, or with ``--multihost`` and the
coordinator triplet (one process per device, ``--process_id`` the global
rank), it joins that world instead.  Rank 0 writes every file.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from sequoia_tpu_torch.cli import add_compile_cache_arg, add_fleet_args
from sequoia_tpu_torch.data import dataset as ds
from sequoia_tpu_torch.train import cv
from sequoia_tpu_torch.utils.logging import make_log_fn


#: seconds the spawned ``--mesh`` ranks may run before they are killed
SPAWN_TIMEOUT = 7 * 24 * 3600.0


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
    p.add_argument("--mesh", type=str, default=None,
                   help='device mesh for the training step, e.g. "data=8" or '
                        '"data=4,model=2" (gene-head TP); default single-device')
    add_compile_cache_arg(p)
    add_fleet_args(p)
    return p


def parse_mesh(spec: str | None) -> tuple[int | None, int]:
    """``"data=4,model=2"`` -> (4, 2); a missing axis: data None, model 1."""
    if not spec:
        return None, 1
    kv = dict(part.split("=") for part in spec.split(","))
    unknown = set(kv) - {"data", "model"}
    if unknown:
        raise SystemExit(f"--mesh axes are data and model, got {sorted(unknown)}")
    return (int(kv["data"]) if "data" in kv else None), int(kv.get("model", 1))


def resolve_mesh(args):
    """``--multihost`` or a torchrun world -> this rank's
    ``multihost.GlobalMesh``; ``--mesh`` alone -> the string ``"spawn"``
    (:func:`main` starts the local ranks); neither -> None."""
    from sequoia_tpu_torch.parallel import multihost

    n_data, n_model = parse_mesh(args.mesh)
    device = None if args.device == "cuda" else args.device
    if args.multihost or (args.mesh and multihost._in_torchrun()):
        if not args.multihost:
            multihost.initialize()
        mesh = multihost.mesh_from_args(args, n_model=n_model, device=device) \
            if args.multihost else multihost.make_global_mesh(n_model, device=device)
        if n_data is not None and n_data != mesh.shape["data"]:
            raise SystemExit(f"--mesh data={n_data} but the world holds "
                             f"{mesh.shape['data']} x model={n_model} ranks")
        return mesh
    return "spawn" if args.mesh else None


def _rank_main(argv):
    """One spawned rank of ``--mesh``: join the world, run the CV."""
    from sequoia_tpu_torch.parallel import multihost

    args = build_parser().parse_args(argv)
    device = multihost.rank_device(None if args.device == "cuda" else args.device)
    mesh = multihost.make_global_mesh(parse_mesh(args.mesh)[1], device=device)
    _run(args, mesh)


def _spawn(args, argv):
    """Start the ``--mesh`` ranks on this host and wait for them; returns
    rank 0's ``test_results.pkl``."""
    import pickle

    from sequoia_tpu_torch.parallel import multihost, sharding

    n_data, n_model = parse_mesh(args.mesh)
    if args.device == "cuda":
        local = len(sharding.local_devices("cuda"))
        n_data = n_data or local // n_model
        if n_data * n_model > local:
            raise SystemExit(f"--mesh data={n_data},model={n_model} needs "
                             f"{n_data * n_model} CUDA devices; this host has {local}")
        backend, devices = multihost.default_backend(), [
            f"cuda:{r}" for r in range(n_data * n_model)]
    else:
        n_data = n_data or 1
        backend, devices = "gloo", None
    multihost.spawn_local(_rank_main, n_data * n_model, (argv,), backend=backend,
                          devices=devices, timeout=SPAWN_TIMEOUT)
    with open(os.path.join(_save_dir(args), "test_results.pkl"), "rb") as f:
        return pickle.load(f)


def _save_dir(args) -> str:
    return os.path.join(args.src_path, args.save_dir, args.cohort, args.exp_name)


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    mesh = resolve_mesh(args)
    if mesh == "spawn":
        if args.device == "cuda":  # no CUDA: raise here, before any rank starts
            from sequoia_tpu_torch.utils.device import resolve_device

            resolve_device(None)
        return _spawn(args, argv)
    return _run(args, mesh)


def _run(args, mesh) -> dict | None:
    import pandas as pd

    if args.num_genes is not None:
        print("--num_genes is ignored (like the reference's main.py); the pretrained head "
              "width goes in --change_num_genes", file=sys.stderr)
    np.random.seed(args.seed)

    save_dir = _save_dir(args)
    os.makedirs(save_dir, exist_ok=True)
    lead = mesh is None or mesh.rank == 0
    log_fn, finish = make_log_fn(args.log if lead else None, config=vars(args),
                                 name=args.exp_name)

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
        hf_export=args.hf_export, mesh=mesh,
        compute_dtype=None if args.compute_dtype == "float32" else args.compute_dtype,
        moment_dtype=None if args.moment_dtype == "float32" else args.moment_dtype,
        device=None if args.device == "cuda" else args.device)
    finish()
    return out


if __name__ == "__main__":
    main()
