"""Feature extraction over a ref file's slides, and the backbone loading
that serving shares.

Counterpart of ``sequoia_tpu/cli/compute_features.py`` (reference
``pre_processing/compute_features_hdf5.py`` flags and outputs)::

    python -m sequoia_tpu_torch.cli.compute_features --ref_file ref.csv \
        --patch_data_path patches --feature_path features --weights resnet50.pth

``load_extractor``: ``weights`` is a local torch state dict
(``.pt``/``.bin``: torchvision's ResNet-50 names, or timm's ViT names for
UNI and Virchow2, e.g. the MahmoodLab UNI or paige-ai Virchow2
``pytorch_model.bin``) or ``"random"`` (random weights from seed 0, for
benchmarks and smoke runs); nothing is downloaded.  A ViT state dict gives
its own config (``uni_vit.uni_from_torch``, ``uni_vit.virchow2_from_torch``),
with ``compute_dtype`` applied to it.

The CLI runs on CUDA unless ``--device cpu`` is given, and raises without
CUDA.  On CUDA with ``--feat_type resnet`` it extracts through the K4 kernel
in every ResNet stage (:data:`K4_STAGES`, as serving does), in f32 and
bf16, and names the kernel set and the stages on stderr; ``--kernels off``
or ``--device cpu`` runs the plain PyTorch versions.  Where it differs from
the JAX CLI: ``--device`` and ``--kernels`` are new; ``--compilation_cache``
is accepted and unused.

``--data_parallel`` splits each patch batch over this process's devices
(every CUDA device; the CPU is one device), ``batch_size`` dividing by
their count.  ``--multihost`` gives each rank of a fleet its contiguous
share of the ref file's rows (``parallel.multihost.fleet_shard_rows``); the
ranks share nothing else and write the usual per-slide files.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from sequoia_tpu_torch.cli import add_compile_cache_arg, add_fleet_args
from sequoia_tpu_torch.models import resnet, uni_vit
from sequoia_tpu_torch.ops.nn import compute_dtype as to_dtype
from sequoia_tpu_torch.pipeline.features import (FEAT_TYPES, FeatureExtractor,
                                                  compute_features, vit_config)
from sequoia_tpu_torch.train import checkpoint
from sequoia_tpu_torch.utils.device import resolve_device
from sequoia_tpu_torch.utils.profiling import StageTimer


#: the ResNet stages the CLIs run through K4 on CUDA: every one, in f32 and
#: bf16 alike, since K4's chain beats cuDNN's in each (``chip_smoke.py``'s
#: ``chain_totals`` lines, ``PERF.md`` §6)
K4_STAGES = (1, 2, 3, 4)


def kernels_line(kernels: list[str]) -> str:
    """The kernel set as the offline CLIs name it on stderr, with K4's stages."""
    if not kernels:
        return "none (plain PyTorch)"
    stages = f" (stages {', '.join(map(str, K4_STAGES))})" if "bottleneck_chain" in kernels \
        else ""
    return ", ".join(kernels) + stages


def load_extractor(feat_type: str, weights: str, batch_size: int,
                   compute_dtype: str = "float32", data_parallel: bool = False, *,
                   device=None, fused_stages: tuple[int, ...] = (),
                   devices=None) -> FeatureExtractor:
    """A :class:`FeatureExtractor` on ``device`` (CUDA unless given, as every
    entry point), ``fused_stages`` running those ResNet stages' stride-1
    blocks through the K4 kernel (a ResNet option only).

    ``data_parallel``: a data mesh over ``devices``, by default this
    process's devices of ``device``'s type (local devices only, as in JAX:
    a fleet rank drives its own)."""
    if feat_type not in FEAT_TYPES:
        raise ValueError(f"feat_type must be one of {FEAT_TYPES}, got {feat_type!r}")
    mesh = None
    if data_parallel:
        from sequoia_tpu_torch.parallel import sharding as sh

        dev = resolve_device(device)
        local = list(devices) if devices is not None else sh.local_devices(dev.type)
        mesh = sh.make_mesh(n_data=len(local), n_model=1, devices=local)
        device = mesh.first
    dtype = to_dtype(compute_dtype)
    if feat_type != "resnet":
        if fused_stages:
            raise ValueError(f"fused_stages is a ResNet option; the {feat_type} backbone "
                             f"has none")
        if weights == "random":
            cfg = vit_config(feat_type)
            params = uni_vit.random_params(cfg, torch.Generator().manual_seed(0))
        else:
            # the cfg inferred from the state dict, not the default shape
            from_torch = (uni_vit.uni_from_torch if feat_type == "uni"
                          else uni_vit.virchow2_from_torch)
            cfg, params = from_torch(checkpoint.load_torch_checkpoint(weights))
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
        return FeatureExtractor(feat_type, params, batch_size=batch_size, cfg=cfg,
                                device=device, mesh=mesh)
    if weights == "random":
        params = resnet.random_params(torch.Generator().manual_seed(0))
    else:
        params = resnet.resnet50_from_torch(checkpoint.load_torch_checkpoint(weights))
    cfg = resnet.ResNetConfig(compute_dtype=dtype, fused_stages=tuple(fused_stages))
    return FeatureExtractor(feat_type, params, batch_size=batch_size, cfg=cfg, device=device,
                            mesh=mesh)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Per-patch feature extraction (PyTorch/CUDA)")
    p.add_argument("--feat_type", default="resnet", choices=list(FEAT_TYPES))
    p.add_argument("--ref_file", required=True, type=str)
    p.add_argument("--patch_data_path", required=True, type=str)
    p.add_argument("--feature_path", type=str, default="features")
    p.add_argument("--max_patch_number", type=int, default=4000)
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--tcga_projects", default=None, type=str, nargs="*")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--weights", type=str, required=True,
                   help='torch state-dict path, or "random"')
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    p.add_argument("--kernels", default="on", choices=["on", "off"],
                   help="extract with the CUDA kernel K4 (on) or the plain PyTorch versions")
    p.add_argument("--data_parallel", action="store_true",
                   help="split patch batches over this process's devices (batch_size "
                        "must divide evenly by the device count)")
    add_compile_cache_arg(p)
    add_fleet_args(p)
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"slides": slides written, "kernels": [...],
    "stages": the StageTimer's {stage: {"seconds", "items"}}}``."""
    args = build_parser().parse_args(argv)
    import pandas as pd

    dev = resolve_device(None if args.device == "cuda" else args.device)
    df = pd.read_csv(args.ref_file)
    if args.tcga_projects:
        df = df[df["tcga_project"].isin(args.tcga_projects)]
    df = df.iloc[args.start:args.end]
    from sequoia_tpu_torch.parallel import multihost

    df = multihost.fleet_shard_rows(df, args)
    dev = multihost.fleet_device(args, dev)
    print(f"Number of slides = {df.shape[0]}")

    kernels = (["bottleneck_chain"] if dev.type == "cuda" and args.kernels == "on"
               and args.feat_type == "resnet" else [])
    extractor = load_extractor(args.feat_type, args.weights, args.batch_size,
                               args.compute_dtype, args.data_parallel, device=dev,
                               fused_stages=K4_STAGES if kernels else ())
    print(f"compute_features: {dev.type}, kernels: {kernels_line(kernels)}", file=sys.stderr)
    timer = StageTimer()
    done = compute_features(df, args.patch_data_path, args.feature_path, extractor,
                            max_patch_number=args.max_patch_number, seed=args.seed,
                            timer=timer)
    print(f"Extracted features for {done} slides")
    return {"slides": done, "kernels": kernels, "stages": timer.stages}


if __name__ == "__main__":
    main()
