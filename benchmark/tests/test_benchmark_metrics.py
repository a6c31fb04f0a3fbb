"""The trace reduction and every per-layer reader on canned records."""

from __future__ import annotations

import pytest

from benchmark import arith, common, run, trace

MS = 1_000_000  # ns


def canned_events():
    """A 100 ms window: a backbone span (0-40 ms) with a 10 ms upload and two
    kernels of 10 ms, a k-means span (45-60 ms) with one 5 ms kernel, a fold
    span (60-100 ms) with a 20 ms kernel; the device is idle 40-50 ms and
    55-70 ms and 90-100 ms."""
    host = [("bench.window", False, 0, 100 * MS),
            ("bench.backbone", False, 0, 40 * MS), ("aten::conv2d", False, 1 * MS, 30 * MS),
            ("bench.kmeans", False, 45 * MS, 15 * MS), ("aten::multinomial", False, 46 * MS,
                                                        12 * MS),
            ("bench.folds", False, 60 * MS, 40 * MS), ("aten::to", False, 61 * MS, 35 * MS)]
    dev = [("Memcpy HtoD (Pageable -> Device)", True, 0, 10 * MS),
           ("conv_kernel", True, 10 * MS, 10 * MS), ("conv_kernel", True, 20 * MS, 10 * MS),
           ("relu", True, 30 * MS, 10 * MS),
           ("lloyd", True, 50 * MS, 5 * MS), ("vis_gemm", True, 70 * MS, 20 * MS),
           ("bench.backbone", True, 0, 40 * MS)]  # a range on the device: not an operation
    return host + dev


def test_reduce_busy_spans_copies_and_gaps():
    r = trace.reduce(canned_events(), top=2)
    assert r["window_s"] == pytest.approx(0.1)
    assert r["busy_s"] == pytest.approx(0.065)
    assert r["h2d_s"] == pytest.approx(0.010)
    assert r["span_device_s"] == pytest.approx({"backbone": 0.030, "kmeans": 0.005,
                                                "folds": 0.020})
    assert r["span_h2d_s"] == pytest.approx({"backbone": 0.010})
    assert r["device_ops"][0] == ["conv_kernel", pytest.approx(0.020)]
    assert [g[1] for g in r["idle_gaps"]] == pytest.approx([0.015, 0.010])
    assert r["idle_gaps"][0][0] == "bench.folds: aten::to"  # 55-70 ms: mid 62.5 in folds
    assert "bench.backbone" not in r["ops_s"]


def test_reduce_without_a_window_is_none():
    assert trace.reduce([("x", True, 0, 5)]) is None


def canned_record():
    work = {"backbone": ({"bfloat16": 989e12 * 0.003}, 0.0),
            "kmeans": ({"float32": 67e12 * 0.001}, 0.0),
            "folds": ({"bfloat16": 0.0}, 3.35e12 * 0.002)}
    return {"spans": {"backbone": [30.0, 50.0], "kmeans": [4.0, 6.0], "folds": [2.0, 4.0]},
            "items": {"slides": 2, "patches": 8000, "slides_traced": 2, "steps_traced": 10},
            "work": work, "trace": trace.reduce(canned_events()),
            "marks": {"window_s": 10.0, "val_s": 1.5}, "step_flops": 67e12 * 0.001}


@pytest.mark.parametrize("name, value", [
    ("backbone_ms_per_kpatch", 10.0),
    ("backbone_roofline_pct", 10.0),      # 3 ms bound over 30 ms
    ("kmeans_ms_per_slide", 5.0),
    ("kmeans_roofline_pct", 20.0),        # 1 ms over 5 ms
    ("folds_ms_per_slide", 3.0),
    ("folds_roofline_pct", 10.0),         # 2 ms over 20 ms
    ("h2d_ms_per_slide", 5.0),
    ("device_idle_pct.infer", 35.0),
    ("mfu_pct.infer", 100.0 * (989e12 * 0.003 + 67e12 * 0.001) / (0.1 * 989e12)),
    ("mfu_pct.train", 10.0),               # 10 steps x 1 ms of f32 peak over 100 ms
    ("device_idle_pct.train", 35.0),
    ("eval_share_pct.train", 15.0),
])
def test_reader_known_value(name, value):
    assert run.reader(common.ROOT, name).read(canned_record()) == pytest.approx(value)


@pytest.mark.parametrize("name", [p.stem for p in (common.ROOT / "metrics").glob("*.py")])
def test_reader_with_nothing_to_read_returns_none(name):
    empty = {"spans": {}, "items": {}, "work": {}, "trace": None, "marks": None,
             "step_flops": 1.0}
    assert run.reader(common.ROOT, name).read(empty) is None


def test_quantile_is_numpy_linear():
    assert common.quantile([1, 2, 3, 4, 5], 0.95) == pytest.approx(4.8)
    assert arith.PEAK_FLOPS["bfloat16"] == 989e12
