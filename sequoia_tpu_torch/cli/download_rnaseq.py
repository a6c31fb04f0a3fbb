"""TCGA RNA-seq download + filtering via the GDC API.

Counterpart of ``sequoia_tpu/cli/download_rnaseq.py`` (a copy, host only:
no device, pandas imported inside the functions that build tables).

Behavior contract (reference ``pre_processing/download_RNASeq_TCGAbiolinks.R``,
an R/TCGAbiolinks script): per cancer project, fetch STAR-Counts gene
expression, keep ``protein_coding`` / ``miRNA`` / ``lncRNA`` genes whose
median ``fpkm_uq`` across samples is > 0, and write a per-cancer expression
table.  This is the Python/GDC-REST equivalent (no R dependency); it needs
network access to ``api.gdc.cancer.gov`` and is a no-op offline.

Output: ``{out}/{project}_fpkm_uq.csv`` — genes x samples, plus a
``ref_file``-ready transpose helper.
"""

from __future__ import annotations

import argparse
import gzip
import io
import json
import os
import urllib.request

GDC = "https://api.gdc.cancer.gov"
KEEP_TYPES = ("protein_coding", "miRNA", "lncRNA")


def _post(endpoint: str, payload: dict) -> dict:
    req = urllib.request.Request(
        f"{GDC}/{endpoint}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def list_star_counts_files(project: str, max_files: int = 20000) -> list[dict]:
    filters = {"op": "and", "content": [
        {"op": "in", "content": {"field": "cases.project.project_id",
                                 "value": [project]}},
        {"op": "in", "content": {"field": "analysis.workflow_type",
                                 "value": ["STAR - Counts"]}},
        {"op": "in", "content": {"field": "data_category",
                                 "value": ["Transcriptome Profiling"]}},
        {"op": "in", "content": {"field": "access", "value": ["open"]}},
    ]}
    out = _post("files", {
        "filters": filters, "size": max_files,
        "fields": "file_id,file_name,cases.samples.submitter_id"})
    return out["data"]["hits"]


def fetch_star_counts(file_id: str):
    """One STAR-Counts TSV as a pandas DataFrame."""
    import pandas as pd

    with urllib.request.urlopen(f"{GDC}/data/{file_id}", timeout=300) as r:
        raw = r.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return pd.read_csv(io.BytesIO(raw), sep="\t", comment="#")


def build_expression_table(project: str, out_dir: str,
                           max_samples: int | None = None,
                           value_col: str = "fpkm_uq_unstranded") -> str:
    import pandas as pd

    hits = list_star_counts_files(project)
    if max_samples:
        hits = hits[:max_samples]
    cols = {}
    gene_meta = None
    for h in hits:
        df = fetch_star_counts(h["file_id"])
        df = df[df["gene_type"].isin(KEEP_TYPES)]
        sample = h["cases"][0]["samples"][0]["submitter_id"]
        cols[sample] = df.set_index("gene_name")[value_col]
        if gene_meta is None:
            gene_meta = df[["gene_name", "gene_type"]]
    table = pd.DataFrame(cols)
    # reference filter: median FPKM-UQ > 0 across samples
    table = table[table.median(axis=1) > 0]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{project}_fpkm_uq.csv")
    table.to_csv(path)
    return path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GDC STAR-Counts downloader")
    p.add_argument("--projects", type=str, nargs="+", required=True,
                   help="e.g. TCGA-BRCA TCGA-LUAD")
    p.add_argument("--out", type=str, default="rnaseq")
    p.add_argument("--max_samples", type=int, default=None)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    for project in args.projects:
        try:
            path = build_expression_table(project, args.out, args.max_samples)
            print(f"{project}: wrote {path}")
        except Exception as e:
            print(f"{project}: download failed ({e}) — this command needs "
                  "network access to api.gdc.cancer.gov")


if __name__ == "__main__":
    main()
