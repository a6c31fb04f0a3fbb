"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric with new files and new entries only: no file that is
there changes."""

from __future__ import annotations

import hashlib
import json
import shutil
import time

import torch

from benchmark import common, run
from benchmark.tests import tiny


def digest(root) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_dummy_cell_by_new_files_and_entries(tmp_path):
    shutil.copytree(common.ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(common.CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "sequoia-resnet50-vis.json").read_text())
    cfg["name"] = "dummy-resnet50-vis"
    (b / "configs" / "dummy-resnet50-vis.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "slides.json").read_text())
    mix["cycle"]["pairs"] = [[300, 600]]
    (b / "traffic" / "slides-biopsy.json").write_text(json.dumps(mix))
    (b / "limits" / "dummy.slides-biopsy.json").write_text(
        (b / "limits" / "resnet50-vis.slides.json").read_text())
    (b / "metrics" / "patches_per_slide.py").write_text(
        '"""Patches a slide. Layer: serving uploads; source: program_counter;\n'
        'unit: patches, higher is better; moves slides_per_hour."""\n\n\n'
        'def read(rec):\n    n = rec["items"].get("slides")\n'
        '    return rec["items"]["patches"] / n if n else None\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-resnet50-vis", "source": "a test",
                             "file": "benchmark/configs/dummy-resnet50-vis.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.slides-biopsy", "config": "dummy-resnet50-vis",
                               "traffic": "slides-biopsy", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "slides_per_hour":
            m["workloads"].append("dummy.slides-biopsy")
    bench["per_layer"].append({"name": "patches_per_slide", "unit": "patches",
                               "better": "higher", "source": "program_counter",
                               "layer": "serving uploads", "moves": "slides_per_hour",
                               "workloads": ["dummy.slides-biopsy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before

    s = common.spec(tmp_path / "BENCHMARK.json", "dummy.slides-biopsy")
    s["config"] = tiny.merge(s["config"], tiny.TINY["sequoia-resnet50-vis"])
    s["traffic"] = tiny.merge(s["traffic"], dict(tiny.TINY_TRAFFIC["slides"],
                                                 cycle={"full": 16, "full_per_group": 3,
                                                        "pairs": [[6, 10]]}))
    for trace, key in ((False, "slides_per_hour"), (True, "patches_per_slide")):
        result, _ = run.run_cell(s, seed=9, seconds=0.5, trace=trace,
                                 device=torch.device("cpu"), t_start=time.perf_counter())
        assert key in result["metrics"]
