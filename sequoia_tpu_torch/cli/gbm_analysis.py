"""GBM meta-module co-expression analysis: per-slide correlation clustermaps
+ per-tile module spatial maps from prediction CSVs.

Counterpart of ``sequoia_tpu/cli/gbm_analysis.py`` (reference
``spatial_vis/gbm_celltype_analysis.py`` as a CLI), the same flags and
outputs.  Host code only: pandas, matplotlib and seaborn, imported when used.
"""

from __future__ import annotations

import argparse
import os

from sequoia_tpu_torch.evaluation import gbm_modules


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GBM meta-module analysis")
    p.add_argument("--pred_csv", type=str, nargs="+", required=True,
                   help="stride-1.csv prediction maps (one per slide)")
    p.add_argument("--module_dir", type=str, required=True,
                   help="directory of {AC,G1S,G2M,MES1,MES2,NPC1,NPC2,OPC}.npy")
    p.add_argument("--save_folder", type=str, required=True)
    p.add_argument("--corr_method", type=str, default="pearson",
                   choices=["pearson", "spearman"])
    p.add_argument("--merged", type=int, default=1,
                   help="color tiles by the reference's merged categories "
                        "(ac/cc/mes/lin) instead of raw modules")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    import pandas as pd

    modules = gbm_modules.load_modules(args.module_dir)
    if not modules:
        raise SystemExit(f"no module .npy files found in {args.module_dir}")
    coloring = (gbm_modules.merge_categories(modules)
                if args.merged else modules)
    os.makedirs(args.save_folder, exist_ok=True)

    corr_dfs = []
    for csv in args.pred_csv:
        name = os.path.basename(os.path.dirname(csv)) or \
            os.path.splitext(os.path.basename(csv))[0]
        df = pd.read_csv(csv)
        corr = gbm_modules.correlation_matrix(df, modules, args.corr_method)
        corr_dfs.append(corr)
        corr.to_csv(os.path.join(args.save_folder, f"{name}_corr.csv"))
        gbm_modules.plot_clustermap(
            corr, os.path.join(args.save_folder, f"{name}_clustermap.png"))
        assign = gbm_modules.assign_modules(df, coloring)
        assign.to_csv(os.path.join(args.save_folder, f"{name}_modules.csv"))
        gbm_modules.plot_spatial_modules(
            df, assign, os.path.join(args.save_folder, f"{name}_spatial.png"))
        print(f"{name}: wrote corr/clustermap/modules/spatial outputs")

    if len(corr_dfs) > 1:
        # across-slide mean correlation (reference total_clustered map)
        total = gbm_modules.average_correlation(corr_dfs)
        total.to_csv(os.path.join(args.save_folder, "total_corr.csv"))
        gbm_modules.plot_clustermap(
            total, os.path.join(args.save_folder, "total_clustermap.png"))


if __name__ == "__main__":
    main()
