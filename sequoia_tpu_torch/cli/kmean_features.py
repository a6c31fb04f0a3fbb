"""Per-slide k-means cluster features over a ref file's feature stores.

Counterpart of ``sequoia_tpu/cli/kmean_features.py`` (reference
``pre_processing/kmean_features.py`` flags and outputs)::

    python -m sequoia_tpu_torch.cli.kmean_features --ref_file ref.csv \\
        --feature_path features [--backend device|hybrid|sklearn]

The fit is seeded with 0 whatever ``--seed`` says: the reference hard-codes
``KMeans(random_state=0)``.  ``--backend device`` is the port's name for the
JAX CLI's ``tpu`` (kmeans++ and Lloyd on the card); ``hybrid`` seeds on the
host with sklearn's exact stream and runs Lloyd on the card; ``sklearn`` is
the reference's own ``KMeans`` on the host and needs scikit-learn.  It runs on
CUDA unless ``--device cpu`` is given, and raises without CUDA; on CUDA the
Lloyd steps run through the K5 kernel, named on stderr, unless
``--kernels off``.  Where it differs from the JAX CLI: ``--device`` and
``--kernels`` are new, and ``tpu`` (the JAX default) is taken as ``device``.
``--multihost`` gives each rank of a fleet its contiguous share of the ref
file's rows (``parallel.multihost.fleet_shard_rows``).
"""

from __future__ import annotations

import argparse
import sys

from sequoia_tpu_torch.cli import add_fleet_args
from sequoia_tpu_torch.pipeline import kmeans_stage
from sequoia_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="K-means cluster features (PyTorch/CUDA)")
    p.add_argument("--ref_file", required=True, type=str)
    p.add_argument("--patch_data_path", type=str, default=None,
                   help="(accepted for compatibility; unused)")
    p.add_argument("--feature_path", type=str, default="features")
    p.add_argument("--num_clusters", type=int, default=100)
    p.add_argument("--feat_name", type=str, default="resnet_features")
    p.add_argument("--tcga_projects", default=None, type=str, nargs="*")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--gtex", action="store_true")
    p.add_argument("--gtex_tissue", type=str, default=None)
    p.add_argument("--seed", type=int, default=99,
                   help="(accepted for compatibility; the fit is seeded with 0, as the "
                        "reference's KMeans(random_state=0))")
    p.add_argument("--backend", type=str, default="device",
                   choices=["device", "tpu", "hybrid", "sklearn"],
                   help="device: kmeans++ and Lloyd on the card (tpu: the JAX name of "
                        "it); hybrid: sklearn's seeding on the host, Lloyd on the card; "
                        "sklearn: the reference's KMeans on the host")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    p.add_argument("--kernels", default="on", choices=["on", "off"],
                   help="run the Lloyd steps through the CUDA kernel K5 and the device "
                        "backend's kmeans++ through kmeans_seed (on), or the plain "
                        "PyTorch versions")
    add_fleet_args(p)
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"slides": slides clustered, "kernels": [...]}``."""
    args = build_parser().parse_args(argv)
    if args.backend == "tpu":
        args.backend = "device"
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

    # K5 for the Lloyd steps; the device backend seeds through kmeans_seed too
    kernels = ((["lloyd_stats"] + (["kmeans_seed"] if args.backend == "device" else []))
               if dev.type == "cuda" and args.kernels == "on" and args.backend != "sklearn"
               else [])
    print(f"kmean_features: {dev.type}, backend {args.backend}, kernels: "
          + (", ".join(kernels) or "none"), file=sys.stderr)
    done = kmeans_stage.run_kmeans(
        df, args.feature_path, num_clusters=args.num_clusters, feat_name=args.feat_name,
        seed=0, backend=args.backend, gtex_tissue=args.gtex_tissue if args.gtex else None,
        use_pallas=bool(kernels), device=dev)
    print(f"Clustered {done} slides. Done!")
    return {"slides": done, "kernels": kernels}


if __name__ == "__main__":
    main()
