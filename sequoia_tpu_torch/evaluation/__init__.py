"""Evaluation of trained folds: per-gene statistics of ``test_results.pkl``,
independent-cohort prediction, and scores of spatial maps (EMD against
spatial transcriptomics, GBM meta-modules)."""

from sequoia_tpu_torch.evaluation import correlation_stats, evaluate_model  # noqa: F401
