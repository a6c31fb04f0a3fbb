"""Each entry at a tiny size on the CPU through the program's plain
versions: the result line has its fixed keys, a sound run is correct,
and a run imports nothing of the JAX side."""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from benchmark import common, run
from benchmark.tests import tiny

CELLS = ["resnet50-vis.slides", "uni-vis.slides", "resnet50-vis.features",
         "resnet50-vis.train"]


def run_tiny(workload: str, trace: bool, seed: int = 2 ** 31 + 11, fault=None,
             bench_json=None):
    s = tiny.spec(workload, bench_json)
    return run.run_cell(s, seed=seed, seconds=1.0, trace=trace, device=torch.device("cpu"),
                        t_start=time.perf_counter(), fault=fault)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_entry_prints_the_result_line(workload, trace):
    result, checks = run_tiny(workload, bool(trace))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        common.emit(result, checks)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert err.getvalue().strip().splitlines()[-1].startswith("checks: ")
    s = common.spec(common.CHECKOUT / "BENCHMARK.json", workload)
    want = {m["name"] for m in (s["per_layer"] if trace else s["end_to_end"])}
    assert set(line["metrics"]) <= want
    if not trace:  # the host-clock metrics exist on the CPU too
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    assert set(line["checks"]) == set(s["limits"])


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is for machines without one")
    assert run.main(["--workload", "resnet50-vis.slides", "--seed", "1", "--seconds",
                     "1"]) == 2
    assert capsys.readouterr().out == ""


def test_a_run_imports_nothing_of_the_jax_side():
    code = ("import time, torch\n"
            "from benchmark import run, common\n"
            "from benchmark.tests import tiny\n"
            "for w in %r:\n"
            "    run.run_cell(tiny.spec(w), seed=5, seconds=0.3, trace=True,\n"
            "                 device=torch.device('cpu'), t_start=time.perf_counter())\n"
            "import benchmark.control\n"
            "print('FORBIDDEN', common.forbidden_loaded())\n") % (CELLS,)
    out = subprocess.run([sys.executable, "-c", code], cwd=common.CHECKOUT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN []"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sequoia_tpu_torch_fake", object())
    assert "sequoia_tpu" not in common.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in common.forbidden_loaded()
