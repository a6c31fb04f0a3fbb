"""EMD comparison of spatial prediction maps vs spatial-transcriptomics
ground truth.

Counterpart of ``sequoia_tpu/cli/get_emd.py`` (reference
``spatial_vis/get_emd.py`` CLI contract), the same flags and outputs.  Host
code only: it needs ``cv2`` (and scanpy for ``--h5ad``), imported when used.

Ground truth comes from a Visium h5ad (requires scanpy) or a CSV with
``x, y, gene_expr`` columns per gene (``--gt_csv_template`` with ``{gene}``).
Writes ``metrics.csv`` with raw + median-filtered/percentile EMD per gene.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sequoia_tpu_torch.evaluation import spatial_metrics as sm


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="EMD vs spatial ground truth")
    p.add_argument("--pred_csv", type=str, default=None,
                   help="stride-1.csv prediction map")
    p.add_argument("--gene_names", type=str, required=True,
                   help="comma-separated genes or .npy of names")
    p.add_argument("--save_folder", type=str, required=True)
    p.add_argument("--h5ad", type=str, default=None,
                   help="spatial ground-truth AnnData (needs scanpy)")
    p.add_argument("--gt_csv_template", type=str, default=None,
                   help="per-gene CSV template with {gene}, columns x,y,gene_expr")
    p.add_argument("--num_tiles", type=int, default=4,
                   help="GT spots averaged per prediction tile")
    # reference-compat flags (get_emd.py:100-110): reconstruct the GBM
    # dataset layout from a slide number + prediction folder name
    p.add_argument("--slide_nr", type=str, default=None,
                   help="reference-compat: spatial-GBM slide number")
    p.add_argument("--pred_folder", type=str, default=None,
                   help="reference-compat: folder under "
                        "visualizations/spatial_GBM_pred/")
    p.add_argument("--data_root", type=str, default=".",
                   help="reference-compat: base of the ./visualizations and "
                        "./data trees")
    return p


def resolve_reference_layout(args) -> None:
    """Fill pred_csv / h5ad / save_folder from the reference's hard-coded
    GBM path scheme (``get_emd.py:107-122``) when --slide_nr is given."""
    slide_name = f"HRI_{args.slide_nr}_T.tif"
    if args.pred_csv is None:
        if args.pred_folder is None:
            raise SystemExit("--slide_nr needs --pred_folder (or an explicit "
                             "--pred_csv)")
        args.pred_csv = os.path.join(
            args.data_root, "visualizations", "spatial_GBM_pred",
            args.pred_folder, slide_name, "stride-1.csv")
    if args.h5ad is None and args.gt_csv_template is None:
        args.h5ad = os.path.join(
            args.data_root, "data", "Spatial_Heiland", "data",
            "AnnDataObject", "raw", f"{args.slide_nr}_T.h5ad")
    args.save_folder = os.path.join(
        args.data_root, "visualizations", "comparisons", args.save_folder,
        slide_name)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    import pandas as pd

    if args.slide_nr is not None:
        resolve_reference_layout(args)
    if args.pred_csv is None:
        raise SystemExit("provide --pred_csv, or --slide_nr/--pred_folder")
    if args.gene_names.endswith(".npy"):
        genes = [str(g) for g in np.load(args.gene_names, allow_pickle=True)]
    else:
        genes = args.gene_names.split(",")

    pred_df = pd.read_csv(args.pred_csv)
    # preprocess the AnnData ONCE (normalize/log1p/scale are gene-
    # independent; reloading per gene turns minutes into hours)
    adata = sm.load_ground_truth_adata(args.h5ad) if args.h5ad else None
    rows = []
    for gene in genes:
        try:
            if adata is not None:
                gt = sm.ground_truth_gene_df(adata, gene)
            elif args.gt_csv_template:
                gt = pd.read_csv(args.gt_csv_template.format(gene=gene))
            else:
                raise SystemExit("provide --h5ad or --gt_csv_template")
            out = sm.emd_for_gene(pred_df, gt, gene, num_tiles=args.num_tiles)
            rows.append({"gene": gene, **out})
        except Exception as e:
            print(f"{gene}: {e}")

    os.makedirs(args.save_folder, exist_ok=True)
    pd.DataFrame(rows).to_csv(os.path.join(args.save_folder, "metrics.csv"),
                              index=False)
    print(f"wrote {args.save_folder}/metrics.csv ({len(rows)} genes)")


if __name__ == "__main__":
    main()
