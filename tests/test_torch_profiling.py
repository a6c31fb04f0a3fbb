"""The port's spans and counters (``utils/profiling.py``) on the CPU: off
without a profiler, and under one the serving path's span tree with one
request id, the Lloyd step counter against ``kmeans_fit``'s ``n_iter``, the
ranges on the profiler's own events, the training loop's spans (the upload
on the reader thread with its batch's request), self time, the
``spans.json`` beside ``device_trace``'s trace, and the benchmark's
wrappers still seeing every call."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import serving
from benchmark import trace as btrace
from sequoia_tpu_torch.data.dataset import Batch
from sequoia_tpu_torch.models import resnet, vis
from sequoia_tpu_torch.ops import kmeans as km
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.serve import SlidePredictor
from sequoia_tpu_torch.train import loop
from sequoia_tpu_torch.utils import profiling

K, D, N = 4, 16, 40
CFG = vis.ViSConfig(num_outputs=6, input_dim=D, depth=1, nheads=2, dim_f=4, dim_s=4, dim_c=4,
                    num_clusters=K)


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def _predictor(extractor=None):
    folds = [(CFG, vis.init(CFG, torch.Generator().manual_seed(i))) for i in range(2)]
    return SlidePredictor(extractor, folds, n_clusters=K, device="cpu")


def _features(seed=0, n=N):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def test_off_records_nothing():
    pred = _predictor()
    pred.predict_features(_features())
    profiling.count("host_syncs", 3)
    with profiling.span("x", bytes=1) as s:
        assert s is None
    assert profiling.summary() == {"spans": {}, "counters": {}}
    assert profiling.records() == []
    assert profiling.new_request() is None and profiling.current_request() is None


def test_serving_span_tree_one_request():
    pred = _predictor()
    _, prof = _traced(lambda: pred.predict_features(_features()))
    recs = _by_name(profiling.records())
    (slide,), (kmeans,), (seed,), (lloyd,) = (recs[n] for n in ("serve.slide", "serve.kmeans",
                                                                 "kmeans.seed", "kmeans.lloyd"))
    assert slide["parent"] is None and kmeans["parent"] == slide["id"]
    assert {seed["parent"], lloyd["parent"]} == {kmeans["id"]}
    assert len(recs["kmeans.means"]) == 2  # the final assignment, the cluster means
    assert {r["parent"] for r in recs["kmeans.means"]} == {kmeans["id"]}
    assert {r["parent"] for r in recs["serve.folds"] + recs["serve.readback"]} == {slide["id"]}
    every = [r for rs in recs.values() for r in rs]
    assert {r["request"] for r in every} == {slide["id"]}
    (upload,) = recs["serve.upload"]  # the features to the predictor's device
    assert upload["parent"] == kmeans["id"] and upload["attrs"] == {"bytes": N * D * 4}
    # the profiler's own events hold the ranges, each child inside its parent
    ev = {e[0]: e for e in btrace.events_of(prof) if not e[1]}
    for child, parent in (("serve.kmeans", "serve.slide"), ("kmeans.seed", "serve.kmeans"),
                          ("kmeans.lloyd", "serve.kmeans"), ("serve.folds", "serve.slide")):
        c, p = ev[child], ev[parent]
        assert p[2] <= c[2] and c[2] + c[3] <= p[2] + p[3], (child, parent)


def test_lloyd_steps_and_host_syncs():
    pred = _predictor()
    n_iters = []
    fit = km.kmeans_fit

    def counted(*a, **kw):
        out = fit(*a, **kw)
        n_iters.append(int(out[3]))
        return out

    km.kmeans_fit = counted
    try:
        _traced(lambda: [pred.predict_features(_features(s)) for s in range(3)])
    finally:
        km.kmeans_fit = fit
    c = profiling.summary()["counters"]
    assert len(n_iters) == 3 and c["kmeans.lloyd_steps"] == sum(n_iters)
    # a slide: the valid count and each step (Lloyd), the masked select,
    # bincount and bool (the repair's check), the genes' readback; the
    # seeding reads nothing back
    fixed = 1 + (1 + profiling.BINCOUNT_SYNCS + 1) + 1
    assert c["host_syncs"] == 3 * fixed + sum(n_iters)


def test_same_name_reentry_records_once():
    pred = _predictor()
    _traced(lambda: pred.predict_cluster_features(
        pred.cluster(torch.as_tensor(_features()))))
    s = profiling.summary()["spans"]
    assert "serve.slide" not in s and s["serve.kmeans"]["count"] == 1
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a"):
            with profiling.span("a"):
                with profiling.span("b"):
                    pass
    s = profiling.summary()["spans"]
    assert s["a"]["count"] == 1 and s["b"]["count"] == 1


def test_self_time_is_host_time_less_children():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer"):
            time.sleep(0.004)
            for _ in range(2):
                with profiling.span("inner"):
                    time.sleep(0.003)
    s = profiling.summary()["spans"]
    o, i = s["outer"], s["inner"]
    assert i["count"] == 2 and i["self_host_ms"] == pytest.approx(i["host_ms"])
    assert o["self_host_ms"] == pytest.approx(o["host_ms"] - i["host_ms"])
    assert o["self_host_ms"] >= 4.0 and o["device_ms"] == pytest.approx(o["host_ms"])


def test_request_on_another_thread_and_counter_across_threads():
    def work(rid):
        with profiling.span("side", request=rid):
            for _ in range(100):
                profiling.count("n")

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("root") as root:
            ts = [threading.Thread(target=work, args=(profiling.current_request(),))
                  for _ in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    recs = _by_name(profiling.records())
    assert len(recs["side"]) == 8
    assert {r["request"] for r in recs["side"]} == {root.id}
    assert {r["parent"] for r in recs["side"]} == {None}
    assert profiling.summary()["counters"]["n"] == 800


def _loaders(n_train=3, n_val=2, b=2, tokens=K, g=6):
    rng = np.random.default_rng(3)

    def batches(n):
        return [Batch(rng.normal(size=(b, tokens, D)).astype(np.float32),
                      rng.normal(size=(b, g)).astype(np.float32), np.ones(b, bool),
                      ["w"] * b, ["p"] * b) for _ in range(n)]
    return {"train": batches(n_train), "val": batches(n_val)}


def test_train_loop_spans():
    params = vis.init(CFG, torch.Generator().manual_seed(0))
    loaders = _loaders()
    main = threading.get_ident()
    _traced(lambda: loop.train(lambda p, x: vis.apply(CFG, p, x), params,
                               lambda p: loop.make_adamw(p, lr=1e-3), loaders, num_epochs=1,
                               verbose=False, device="cpu"))
    recs = _by_name(profiling.records())
    assert len(recs["train.step"]) == 3 and len(recs["train.eval_step"]) == 2
    # one wait a batch, and one a phase for the reader's end
    assert len(recs["train.batch_wait"]) == 3 + 2 + 2
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert sorted(r["parent"] for r in recs[name]) == sorted(
            r["id"] for r in recs["train.step"])
    ups = recs["train.upload"]
    assert len(ups) == 5 and {r["thread"] for r in ups} != {main}
    assert {r["request"] for r in ups} == {r["id"] for r in ups}  # a reader thread's roots
    assert sorted(r["request"] for r in recs["train.step"] + recs["train.eval_step"]) == sorted(
        r["request"] for r in ups)
    assert len(recs["train.readback"]) == 2 and len(recs["train.snapshot"]) == 1


def test_device_trace_writes_spans_json(tmp_path):
    pred = _predictor()
    profiling.count("stale")  # no profiler: nothing kept
    with profiling.device_trace(str(tmp_path / "t")):
        pred.predict_features(_features())
    got = json.loads((tmp_path / "t" / "spans.json").read_text())
    assert got["spans"]["serve.slide"]["count"] == 1
    assert got["counters"]["kmeans.lloyd_steps"] >= 1 and "stale" not in got["counters"]
    assert {r["name"] for r in got["records"]} >= {"serve.kmeans", "kmeans.seed", "serve.folds"}
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0


def test_stage_timer_opens_a_span():
    timer = profiling.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.stage("extract", items=3):
            pass
    assert profiling.records()[0]["name"] == "extract"
    assert profiling.records()[0]["attrs"] == {"items": 3}
    assert timer.stages["extract"]["items"] == 3


def test_benchmark_wrappers_see_every_call():
    """``benchmark/serving.capture`` wraps the extractor's ``features`` and the
    predictor's ``cluster`` on the instance, and its traced run wraps
    ``kmeans_fit``: ``predict_patches`` still reaches all three."""
    ext = FeatureExtractor("resnet", resnet.random_params(torch.Generator().manual_seed(0)),
                           batch_size=2, patch_size=32, device="cpu")
    cfg = vis.ViSConfig(num_outputs=6, input_dim=ext.feature_dim, depth=1, nheads=2, dim_f=4,
                        dim_s=4, dim_c=4, num_clusters=K)
    pred = SlidePredictor(ext, [(cfg, vis.init(cfg, torch.Generator().manual_seed(1)))],
                          n_clusters=K, patch_size=32, device="cpu")
    last, fits = {}, []
    serving.capture(pred, last)
    fit = km.kmeans_fit
    km.kmeans_fit = lambda *a, **kw: fits.append(1) or fit(*a, **kw)
    try:
        u8 = np.random.default_rng(0).integers(0, 255, (6, 32, 32, 3), dtype=np.uint8)
        genes, _ = _traced(lambda: [pred.predict_patches(u8) for _ in range(2)])
    finally:
        km.kmeans_fit = fit
    assert len(fits) == 2 and last["features"].shape == (6, ext.feature_dim)
    assert last["cf"].shape == (K, ext.feature_dim) and genes[0].shape == (1, 6)
    s = profiling.summary()["spans"]
    assert s["serve.slide"]["count"] == 2 and s["serve.backbone"]["count"] == 6
    # a slide: three patch batches and the features into k-means
    assert s["serve.upload"]["count"] == 8 and s["serve.kmeans"]["count"] == 2
