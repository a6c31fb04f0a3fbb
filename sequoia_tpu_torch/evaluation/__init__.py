"""Evaluation of trained folds: independent-cohort prediction."""
