"""Generate synthetic example data in the reference's input schema.

Counterpart of ``tools/make_example_data.py``: ``{out}/ref_file.csv``
(``wsi_file_name, patient_id, rna_{GENE}..., tcga_project``, the reference's
input contract), ``{out}/gene_list.csv``, and optionally a feature store
(``resnet_features`` and ``cluster_features`` h5 files where the loaders read
them) and synthetic pyramidal WSIs (``{out}/HE/*.tiff``).  The same arguments
write the same files as the JAX package's tool.  pandas, h5py and Pillow are
imported where they are needed; the WSIs need neither h5py nor JAX.

    python -m sequoia_tpu_torch.tools.make_example_data --out examples \\
        --n_slides 5 --n_genes 200 [--features] [--wsis]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sequoia_tpu_torch import native
from sequoia_tpu_torch.data.dataset import slide_h5_path


def gene_names(n: int) -> list[str]:
    return [f"GENE{i:05d}" for i in range(n)]


def load_gene_list(path: str, n_genes: int = 0) -> list[str]:
    """Gene names from a gene_list.csv (``gene_name`` column, or the first
    column), e.g. the real 20,820-gene list that ``import_reference_artifacts``
    imports.  ``n_genes > 0`` truncates."""
    import pandas as pd

    df = pd.read_csv(path)
    col = "gene_name" if "gene_name" in df.columns else df.columns[0]
    genes = [str(g) for g in df[col]]
    return genes[:n_genes] if n_genes and n_genes > 0 else genes


def make_ref_file(out: str, n_slides: int, n_genes: int, project: str,
                  seed: int = 0, genes: list[str] | None = None):
    """Write ``ref_file.csv`` and ``gene_list.csv``; returns the ref-file
    DataFrame."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    genes = genes if genes is not None else gene_names(n_genes)
    n_genes = len(genes)
    rows = []
    for i in range(n_slides):
        row = {
            "wsi_file_name": f"SYNTH-{project.split('-')[-1]}-{i:04d}.svs",
            "patient_id": f"SYNTH-PAT-{i // 2:04d}",
        }
        base = rng.normal(size=n_genes) * 2 + 8
        for g, v in zip(genes, base):
            row[f"rna_{g}"] = round(float(np.maximum(v, 0)), 4)
        row["tcga_project"] = project
        rows.append(row)
    df = pd.DataFrame(rows)
    os.makedirs(out, exist_ok=True)
    df.to_csv(os.path.join(out, "ref_file.csv"), index=False)
    pd.DataFrame({"gene_name": genes}).to_csv(
        os.path.join(out, "gene_list.csv"), index=False)
    return df


def make_feature_store(out: str, df, dim: int = 2048, tokens: int = 100,
                       n_patches: int = 500, seed: int = 0) -> None:
    """Random ``resnet_features`` and ``cluster_features`` per slide, at the
    path the loaders resolve (``data.dataset.slide_h5_path``, its GTEX
    ``.svs`` quirk included)."""
    import h5py

    rng = np.random.default_rng(seed)
    for _, row in df.iterrows():
        path = slide_h5_path(os.path.join(out, "features"),
                             row["tcga_project"], row["wsi_file_name"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with h5py.File(path, "w") as f:
            f.create_dataset("resnet_features",
                             data=rng.normal(size=(n_patches, dim)).astype(np.float32))
            f.create_dataset("cluster_features",
                             data=rng.normal(size=(tokens, dim)).astype(np.float32))


def synthetic_levels(w: int = 2048, h: int = 1536, seed: int = 0) -> list[np.ndarray]:
    """Level 0 and a 4x-downsampled level 1 of a slide with a textured pink
    tissue blob on a white background (the JAX package's ``synthetic_wsi``
    of ``tests/test_pipeline_e2e.py``, its levels)."""
    rng = np.random.default_rng(seed)
    lv0 = np.full((h, w, 3), 242, np.uint8)
    ys, xs = np.mgrid[0:h, 0:w]
    blob = ((ys - h / 2) ** 2 / (h / 2.5) ** 2 + (xs - w / 3) ** 2 / (w / 3) ** 2) < 1
    tex = rng.integers(-40, 40, size=(h, w, 3))
    tissue_color = np.array([188, 105, 160])
    lv0[blob] = np.clip(tissue_color + tex, 0, 255).astype(np.uint8)[blob]
    return [lv0, lv0[::4, ::4].copy()]


def make_wsis(out: str, df, seed: int = 0) -> None:
    """One pyramidal TIFF per slide under ``{out}/HE``: the native writer
    (128-px tiles) where it builds, else Pillow's multi-page TIFF."""
    os.makedirs(os.path.join(out, "HE"), exist_ok=True)
    for i, (_, row) in enumerate(df.iterrows()):
        levels = synthetic_levels(seed=seed + i)
        stem = row["wsi_file_name"].replace(".svs", "")
        path = os.path.join(out, "HE", stem + ".tiff")
        if native.available():
            native.write_tiled_tiff(path, levels, tile=(128, 128))
        else:
            from PIL import Image

            Image.fromarray(levels[0]).save(
                path, save_all=True, append_images=[Image.fromarray(lv) for lv in levels[1:]])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", type=str, default="examples")
    p.add_argument("--n_slides", type=int, default=5)
    p.add_argument("--n_genes", type=int, default=200)
    p.add_argument("--project", type=str, default="TCGA-SYNT")
    p.add_argument("--features", action="store_true",
                   help="also write a synthetic feature store")
    p.add_argument("--wsis", action="store_true",
                   help="also write synthetic pyramidal WSIs")
    p.add_argument("--feature_dim", type=int, default=2048)
    p.add_argument("--n_tokens", type=int, default=100,
                   help="cluster tokens per slide in the synthetic feature "
                        "store (the reference contract is 100)")
    p.add_argument("--gene_list", type=str, default=None,
                   help="use gene names from this CSV (e.g. the imported "
                        "real 20,820-gene list) instead of GENE##### "
                        "synthetics; --n_genes <= 0 keeps all of them")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    genes = (load_gene_list(args.gene_list, args.n_genes)
             if args.gene_list else None)
    df = make_ref_file(args.out, args.n_slides, args.n_genes, args.project,
                       genes=genes)
    if args.features:
        make_feature_store(args.out, df, dim=args.feature_dim,
                           tokens=args.n_tokens)
    if args.wsis:
        make_wsis(args.out, df)
    n_rna = sum(c.startswith("rna_") for c in df.columns)
    print(f"wrote {args.out}/ref_file.csv ({len(df)} slides, {n_rna} genes)")


if __name__ == "__main__":
    main()
