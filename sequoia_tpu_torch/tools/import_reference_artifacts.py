"""Import the reference's released data artifacts into this repo's layout.

Counterpart of ``tools/import_reference_artifacts.py``.  The real artifacts
define the interop contracts: ``examples/gene_list.csv`` fixes the 20,820-gene
order the released HF fold weights were trained against (reference
``README.md:91,143``); ``patient_splits.zip``, ``test_wsis.pkl`` and
``src/folds/test-{cancer}-{fold}.npy`` pin the paper's CV membership.  This
tool copies and validates them from a sequoia-pub checkout into ``{out}/``:

    examples/gene_list.csv            20,820 gene symbols, original order
    examples/ref_file.csv             5-WSI example in the input schema
    splits/patient_splits/TCGA-*.npy  16 cancers x 5 folds patient IDs
    splits/test_wsis.pkl              {cancer: {split_i: [wsi ids]}}
    splits/folds/test-{c}-{i}.npy     80 per-fold WSI-ID arrays

in the formats the port's loaders read (``data/splits.py``
``load_shipped_patient_splits`` / ``load_test_wsis``; ``data/dataset.py``
reads the ref-file schema).  pandas is imported where it is needed.

    python -m sequoia_tpu_torch.tools.import_reference_artifacts \\
        --reference /path/to/sequoia-pub [--out .]
"""

from __future__ import annotations

import argparse
import io
import os
import pickle
import shutil
import zipfile

import numpy as np

from sequoia_tpu_torch.data.splits import ensure_legacy_pandas_unpickle


def import_gene_list(ref: str, out_examples: str) -> list[str]:
    import pandas as pd

    df = pd.read_csv(os.path.join(ref, "examples", "gene_list.csv"))
    genes = df[df.columns[-1]].astype(str).tolist()
    os.makedirs(out_examples, exist_ok=True)
    df.to_csv(os.path.join(out_examples, "gene_list.csv"), index=False)
    return genes


def import_ref_file(ref: str, out_examples: str):
    import pandas as pd

    df = pd.read_csv(os.path.join(ref, "examples", "ref_file.csv"))
    rna = [c for c in df.columns if c.startswith("rna_")]
    missing = {"wsi_file_name", "patient_id"} - set(df.columns)
    if missing:
        raise ValueError(f"ref_file.csv missing columns {missing}")
    os.makedirs(out_examples, exist_ok=True)
    df.to_csv(os.path.join(out_examples, "ref_file.csv"), index=False)
    print(f"ref_file.csv: {len(df)} WSIs x {len(rna)} rna_ columns")
    return df


def import_patient_splits(ref: str, out_splits: str) -> dict[str, int]:
    """Unpack patient_splits.zip -> {out_splits}/patient_splits/TCGA-*.npy,
    skipping macOS junk entries; validate the fold dict structure."""
    src = os.path.join(ref, "pre_processing", "patient_splits.zip")
    dst = os.path.join(out_splits, "patient_splits")
    os.makedirs(dst, exist_ok=True)
    counts = {}
    ensure_legacy_pandas_unpickle()
    with zipfile.ZipFile(src) as z:
        for name in z.namelist():
            base = os.path.basename(name)
            if (not base.endswith(".npy") or "__MACOSX" in name
                    or base.startswith("._")):
                continue
            data = z.read(name)
            obj = np.load(io.BytesIO(data), allow_pickle=True).item()
            for i in range(len(obj)):
                fold = obj.get(f"fold_{i}", obj.get(i))
                if fold is None or not {"train", "val", "test"} <= set(fold):
                    raise ValueError(f"{base}: fold {i} malformed")
            with open(os.path.join(dst, base), "wb") as f:
                f.write(data)
            counts[base.removesuffix(".npy")] = len(obj)
    return counts


def import_test_wsis(ref: str, out_splits: str) -> dict:
    src = os.path.join(ref, "pre_processing", "test_wsis.pkl")
    ensure_legacy_pandas_unpickle()
    with open(src, "rb") as f:
        obj = pickle.load(f)
    if not isinstance(obj, dict):
        raise ValueError("test_wsis.pkl: expected {cancer: {split: ids}}")
    os.makedirs(out_splits, exist_ok=True)
    shutil.copyfile(src, os.path.join(out_splits, "test_wsis.pkl"))
    return obj


def import_folds(ref: str, out_splits: str) -> int:
    src = os.path.join(ref, "src", "folds")
    dst = os.path.join(out_splits, "folds")
    os.makedirs(dst, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(src)):
        if not name.endswith(".npy"):
            continue
        arr = np.load(os.path.join(src, name), allow_pickle=True)
        if arr.ndim != 1:
            raise ValueError(f"{name}: expected 1-D WSI-ID array")
        shutil.copyfile(os.path.join(src, name), os.path.join(dst, name))
        n += 1
    return n


def run(reference: str, out: str) -> dict:
    out_examples = os.path.join(out, "examples")
    out_splits = os.path.join(out, "splits")

    genes = import_gene_list(reference, out_examples)
    ref_df = import_ref_file(reference, out_examples)
    split_counts = import_patient_splits(reference, out_splits)
    test_wsis = import_test_wsis(reference, out_splits)
    n_folds = import_folds(reference, out_splits)

    # cross-checks: gene order vs ref-file columns; split file coverage
    rna = [c.removeprefix("rna_") for c in ref_df.columns if c.startswith("rna_")]
    summary = {
        "n_genes": len(genes),
        "ref_file_wsis": len(ref_df),
        "gene_order_matches_ref_file": rna == genes[:len(rna)] if rna else False,
        "patient_split_files": len(split_counts),
        "folds_per_cancer": sorted(set(split_counts.values())),
        "test_wsis_cancers": len(test_wsis),
        "fold_arrays": n_folds,
    }
    for k, v in summary.items():
        print(f"{k}: {v}")
    return summary


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reference", required=True, help="path to a sequoia-pub checkout")
    p.add_argument("--out", default=".", help="destination root (default: repo root)")
    args = p.parse_args(argv)
    run(args.reference, args.out)


if __name__ == "__main__":
    main()
