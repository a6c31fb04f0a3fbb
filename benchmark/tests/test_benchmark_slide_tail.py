"""The features cell's slide tail, read per layer from the traced run's
slides outside the profiler session (``metrics/slide_p95_ms.py``)."""

from __future__ import annotations

import pytest

from benchmark import common, run
from benchmark.tests.test_benchmark_entries import run_tiny


def test_reader_known_value():
    rec = {"slide_s": [0.010, 0.020, 0.030, 0.040, 0.050]}
    assert run.reader(common.ROOT, "slide_p95_ms").read(rec) == pytest.approx(48.0)


@pytest.mark.parametrize("trace", [0, 1])
def test_features_cell_reads_the_tail_per_layer_only(trace):
    result, _ = run_tiny("resnet50-vis.features", bool(trace))
    assert "slide_p95_s" not in result["metrics"]
    if trace:
        assert result["metrics"]["slide_p95_ms"]["value"] > 0
        assert result["metrics"]["slide_p95_ms"]["unit"] == "ms"
    else:
        assert "slide_p95_ms" not in result["metrics"]
