"""Per-gene parity check between two ``test_results.pkl`` files.

Counterpart of ``tools/parity_check.py``, the north-star parity gate: the
per-gene Pearson r of one pipeline's predictions must sit within ``--tol``
(1e-3) of the reference pipeline's.  Point it at a reference-produced pickle
and one of the port's (same cohort, same folds); it prints the r deltas and
the prediction-level differences, and exits 1 when a gene is past the
tolerance.

    python -m sequoia_tpu_torch.tools.parity_check --ref ref_test_results.pkl \\
        --ours ours_test_results.pkl [--tol 1e-3]
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from sequoia_tpu_torch.evaluation.evaluate_model import pearson_with_p


def collect(res: dict):
    """(genes, real, pred, wsi) over the ``split_*`` folds of a results dict."""
    folds = sorted(k for k in res if str(k).startswith("split_"))
    real = np.concatenate([np.asarray(res[k]["real"]) for k in folds])
    pred = np.concatenate([np.asarray(res[k]["preds"]) for k in folds])
    wsi = np.concatenate([np.asarray(res[k]["wsi_file_name"]) for k in folds])
    return res["genes"], real, pred, wsi


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Per-gene Pearson parity check")
    p.add_argument("--ref", required=True)
    p.add_argument("--ours", required=True)
    p.add_argument("--tol", type=float, default=1e-3)
    args = p.parse_args(argv)

    with open(args.ref, "rb") as f:
        g1, real1, pred1, wsi1 = collect(pickle.load(f))
    with open(args.ours, "rb") as f:
        g2, real2, pred2, wsi2 = collect(pickle.load(f))

    if list(g1) != list(g2):
        raise ValueError("gene lists differ")
    # align by WSI (fold assignment must match given split parity)
    o1, o2 = np.argsort(wsi1), np.argsort(wsi2)
    if wsi1.shape != wsi2.shape or not (wsi1[o1] == wsi2[o2]).all():
        raise ValueError("cohorts differ")
    real1, pred1 = real1[o1], pred1[o1]
    real2, pred2 = real2[o2], pred2[o2]
    if not np.allclose(real1, real2):
        raise ValueError("targets differ: different ref files?")

    r1, _ = pearson_with_p(real1, pred1)
    r2, _ = pearson_with_p(real2, pred2)
    dr = np.abs(np.nan_to_num(r1) - np.nan_to_num(r2))
    dpred = np.abs(pred1 - pred2)

    print(f"genes: {len(g1)}   slides: {real1.shape[0]}")
    print(f"per-gene |dr|:   max {dr.max():.2e}  mean {dr.mean():.2e}  "
          f"p99 {np.percentile(dr, 99):.2e}")
    print(f"prediction |d|:  max {dpred.max():.2e}  mean {dpred.mean():.2e}")
    n_bad = int((dr > args.tol).sum())
    if n_bad:
        print(f"FAIL: {n_bad} genes exceed |dr| tol {args.tol}:")
        for i in np.argsort(-dr)[:10]:
            print(f"  {g1[i]}: r_ref={r1[i]:+.4f} r_ours={r2[i]:+.4f}")
        return 1
    print(f"PASS: all genes within |dr| <= {args.tol}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
