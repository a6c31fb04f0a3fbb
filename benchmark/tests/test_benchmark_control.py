"""The control of each cell comes out not correct: the reference put in
the program's place one precision below the configuration's, read by the
cell's own numbers against the cell's limits, on three seeds."""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.tests import tiny

SEEDS = [3, 2 ** 31 + 17, 2 ** 32 + 5]


def failed(readings: dict, limits: dict) -> set:
    return {k for k, v in readings.items() if k in limits and not v <= limits[k]}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["resnet50-vis.slides", "uni-vis.slides",
                                      "resnet50-vis.features"])
def test_serving_control_fails(workload, seed):
    s = tiny.spec(workload)
    r = control.serving_control(s, seed, torch.device("cpu"))
    assert failed(r, s["limits"]), r


@pytest.mark.parametrize("seed", SEEDS)
def test_train_half_batch_reference_fails(seed):
    s = tiny.spec("resnet50-vis.train")
    r = control.train_control(s, seed, torch.device("cpu"))
    assert failed(r["half_batch"], s["limits"]), r


def test_train_tf32_control_fails():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card: the CPU computes the control in f32")
    s = tiny.spec("resnet50-vis.train")
    for seed in SEEDS:
        r = control.train_control(s, seed, torch.device("cuda", 0))
        assert failed(r["control"], s["limits"]), r
