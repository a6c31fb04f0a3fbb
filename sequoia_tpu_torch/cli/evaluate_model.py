"""Per-gene offline evaluation -> all/sig/num CSVs.

Counterpart of ``sequoia_tpu/cli/evaluate_model.py`` (reference
``evaluation/evaluate_model.py`` as a CLI), the same flags and outputs::

    python -m sequoia_tpu_torch.cli.evaluate_model --model_dir saved_exp/TCGA \\
        --cancers brca [--folds 5 --save_path results]

Host code only (numpy, scipy, pandas): it reads the ``test_results.pkl``
that ``cli.main`` and ``cli.he2rna`` write.
"""

from __future__ import annotations

import argparse

from sequoia_tpu_torch.evaluation import evaluate_model as em


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate test_results.pkl files")
    p.add_argument("--model_dir", type=str, required=True,
                   help="directory holding {cancer}/test_results.pkl")
    p.add_argument("--cancers", type=str, nargs="*", default=list(em.DEFAULT_CANCERS))
    p.add_argument("--folds", type=int, default=None,
                   help="split count; default auto-detects per cancer")
    p.add_argument("--save_path", type=str, default=None)
    return p


def main(argv=None):
    """Run the CLI; returns ``(all_res, sig_res)``."""
    args = build_parser().parse_args(argv)
    all_res, sig_res = em.evaluate_model_dir(args.model_dir, cancers=args.cancers,
                                             folds=args.folds, save_path=args.save_path)
    print(f"{len(all_res)} gene rows, {len(sig_res)} significant")
    print(sig_res["cancer"].value_counts())
    return all_res, sig_res


if __name__ == "__main__":
    main()
