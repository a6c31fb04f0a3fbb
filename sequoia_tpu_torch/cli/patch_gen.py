"""Tile a directory of WSIs into patches HDF5 files.

Counterpart of ``sequoia_tpu/cli/patch_gen.py`` (reference
``pre_processing/patch_gen_hdf5.py`` flags and outputs)::

    python -m sequoia_tpu_torch.cli.patch_gen --wsi_path slides --patch_path patches \\
        --mask_path patches [--ref_file ref.csv --start 0 --end 10 --layout packed]

Slides are the ``.svs`` / ``.tiff`` files of ``--wsi_path`` in sorted order,
kept where ``--ref_file``'s ``wsi_file_name`` names them (with or without
the extension), then cut to ``--start:--end``; ``--debug`` keeps 5 slides of
20 patches.  A slide's id is its name up to the first dot.  The tissue
screen runs on CUDA unless ``--device cpu`` is given, and raises without
CUDA.  Where it differs from the JAX CLI: ``--device`` is new.
``--multihost`` gives each rank of a fleet its contiguous share of the
sorted slide list (after ``--start:--end``), so every rank cuts the same
list.
"""

from __future__ import annotations

import argparse
import os

from sequoia_tpu_torch.cli import add_fleet_args
from sequoia_tpu_torch.pipeline import patch_gen
from sequoia_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate patches from WSIs (PyTorch/CUDA)")
    p.add_argument("--ref_file", default=None, type=str,
                   help="only WSIs listed in this ref file are processed")
    p.add_argument("--wsi_path", default="examples/HE", type=str)
    p.add_argument("--patch_path", default="examples/Patches_hdf5", type=str)
    p.add_argument("--mask_path", default="examples/Patches_hdf5", type=str)
    p.add_argument("--patch_size", default=256, type=int)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--max_patches_per_slide", default=None, type=int)
    p.add_argument("--debug", default=0, type=int)
    p.add_argument("--layout", default="tiles", choices=["tiles", "packed"],
                   help="HDF5 layout: 'tiles' = reference tile-per-dataset contract; "
                        "'packed' = one chunked (N,ps,ps,3) dataset + coords")
    p.add_argument("--parallel", default=1, type=int,
                   help="(accepted for compatibility; decode parallelism is the "
                        "reader's)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    add_fleet_args(p)
    return p


def main(argv=None) -> dict[str, int]:
    """Run the CLI; returns ``{slide_id: patches written}`` (-1: already
    done) for the slides that did not fail."""
    args = build_parser().parse_args(argv)
    # before the per-slide quarantine, which would report a missing card slide by slide
    device = resolve_device(None if args.device == "cuda" else args.device)
    import pandas as pd

    # sorted: --start/--end job arrays shard by index, so the order must not
    # depend on the filesystem
    slide_list = sorted(s for s in os.listdir(args.wsi_path)
                        if s.endswith(".svs") or s.endswith(".tiff"))
    if args.ref_file:
        names = set(pd.read_csv(args.ref_file)["wsi_file_name"])
        # bare ids in the ref file match either slide extension
        wanted = names | {f"{s}.svs" for s in names} | {f"{s}.tiff" for s in names}
        slide_list = sorted(set(slide_list) & wanted)
    slide_list = slide_list[args.start:args.end]
    from sequoia_tpu_torch.parallel import multihost

    slide_list = multihost.fleet_shard_rows(slide_list, args)
    device = multihost.fleet_device(args, device)
    if args.debug:
        slide_list = slide_list[:5]
        args.max_patches_per_slide = 20

    print(f"Found {len(slide_list)} slides")
    slides = {s.split(".")[0]: os.path.join(args.wsi_path, s) for s in slide_list}
    if len(slides) != len(slide_list):
        print(f"warning: {len(slide_list) - len(slides)} slide(s) share a first-dot stem "
              "with another file and were dropped (slide ids are the stem, reference "
              "patch_gen_hdf5 layout)")
    return patch_gen.run_patch_gen(
        slides, args.patch_path, args.mask_path, patch_size=args.patch_size,
        max_patches_per_slide=args.max_patches_per_slide, layout=args.layout,
        device=device)


if __name__ == "__main__":
    main()
