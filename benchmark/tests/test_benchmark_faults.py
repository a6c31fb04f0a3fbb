"""A run with the timed path broken underneath comes out not correct: for
each fault the cell can have (one card, so no exchange between chips)."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests.test_benchmark_entries import run_tiny

SEED = 2 ** 31 + 11


def altered_genes(pred):
    """An answer altered where it is produced: one gene of every slide."""
    fn = pred.predict_cluster_features

    def altered(cf):
        g = fn(cf)
        g[..., 0] += 1.0
        return g
    pred.predict_cluster_features = altered


def half_batch_means(monkeypatch):
    """Half of the rows left out of the cluster means, the mean taken over
    the rest."""
    from sequoia_tpu_torch.ops import kmeans as km

    means = km.cluster_means

    def half(x, labels, mask, n_clusters=100):
        keep = mask & (torch.arange(x.shape[0], device=x.device) < x.shape[0] // 2)
        return means(x, labels, keep, n_clusters)
    monkeypatch.setattr(km, "cluster_means", half)


def half_batch_features(pred):
    """Half of each backbone batch left out: its rows come back as zeros."""
    fwd = pred.extractor.raw_fwd

    def half(params, u8):
        out = fwd(params, u8)
        out[out.shape[0] // 2:] = 0
        return out
    pred.extractor.raw_fwd = half


@pytest.mark.parametrize("workload", ["resnet50-vis.slides", "uni-vis.slides",
                                      "resnet50-vis.features"])
def test_serving_answer_altered(workload):
    result, _ = run_tiny(workload, False, fault=altered_genes)
    assert result["correct"] is False


@pytest.mark.parametrize("workload, number", [("resnet50-vis.slides", "kmeans_misfit"),
                                              ("uni-vis.slides", "genes_gap"),
                                              ("resnet50-vis.features", "genes_gap")])
def test_serving_half_of_the_rows_in_the_means(workload, number, monkeypatch):
    half_batch_means(monkeypatch)
    result, checks = run_tiny(workload, False)
    assert result["correct"] is False
    assert {c["name"] for c in checks if not c["value"] <= c["limit"]} >= {number}


def test_serving_half_of_the_backbone_batch():
    result, checks = run_tiny("resnet50-vis.slides", False, fault=half_batch_features)
    assert result["correct"] is False
    assert {c["name"] for c in checks if not c["value"] <= c["limit"]} >= {"feat_gap"}


def test_train_step_returns_state_unchanged():
    def frozen(opt):
        opt.step = lambda closure=None: None
    result, checks = run_tiny("resnet50-vis.train", False, fault=frozen)
    assert result["correct"] is False
    assert {c["name"]: c["value"] for c in checks}["update_gap"] == pytest.approx(1.0)


def test_train_half_of_the_batch(monkeypatch):
    from sequoia_tpu_torch.ops import stats

    mse = stats.masked_mse

    def half(pred, target, valid):
        keep = valid & (torch.arange(valid.shape[0], device=valid.device) < valid.shape[0] // 2)
        return mse(pred, target, keep)
    monkeypatch.setattr(stats, "masked_mse", half)
    result, _ = run_tiny("resnet50-vis.train", False)
    assert result["correct"] is False


def after_setup(change):
    """A fault that acts only once the window is open: ``change(opt)``
    before each step from the first step of the second epoch on."""
    import numpy as np
    from sequoia_tpu_torch.data import splits

    from benchmark.tests import tiny

    s = tiny.spec("resnet50-vis.train")
    train_idx, _, _ = splits.patient_split(np.arange(s["traffic"]["cohort"]),
                                           random_state=SEED % 2 ** 32)
    per_epoch = -(-len(train_idx) // s["config"]["train"]["batch_size"])

    def fault(opt):
        n = {"steps": 0}

        def hook(o, *_):
            n["steps"] += 1
            if n["steps"] > per_epoch:
                change(o)
        opt.register_step_pre_hook(hook)
    return fault


@pytest.mark.parametrize("change", [lambda o: o.param_groups[0].update(lr=0.0),
                                    lambda o: o.param_groups[0].update(lr=2e-3)],
                         ids=["unchanged", "double"])
def test_train_step_wrong_only_in_the_window(change):
    """A step that leaves its state unchanged, or moves it double, only
    after set-up, as a step replayed from a capture might."""
    result, checks = run_tiny("resnet50-vis.train", False, seed=SEED,
                              fault=after_setup(change))
    assert result["correct"] is False
    assert {c["name"]: c["value"] for c in checks}["update_gap"] == pytest.approx(1.0, rel=0.05)
