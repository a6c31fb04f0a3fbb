"""``BENCHMARK.json`` and the files it names, held to the benchmark's
format: names, units, keys, files found by name, metric readers that
agree with their entries."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import common, run

BENCH = common.CHECKOUT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads(BENCH.read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(BENCH.read_bytes()) <= 64 * 1024
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word


def test_run_seconds_fit_the_full_check(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark/") and (common.CHECKOUT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    metrics = []
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metrics.append(m["name"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        metrics.append(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    assert len(set(metrics)) == len(metrics)
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        s = common.spec(BENCH, w["name"])
        reported = {m["name"] for m in s["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert s["per_layer"]
        for m in s["per_layer"]:
            assert m["moves"] in reported, (w["name"], m["name"])
        assert set(s["limits"]) and all(isinstance(v, (int, float)) for v in
                                        s["limits"].values())
        assert (s["root"] / "entries" / f"{s['traffic']['entry']}.py").is_file()
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_files_under_paths_are_named_from_name_characters():
    for p in (common.ROOT).rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(common.CHECKOUT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_every_metric_has_a_reader_and_one_spelling_of_its_layer(bench):
    for m in bench["per_layer"]:
        assert callable(run.reader(common.ROOT, m["name"]).read), m["name"]
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_configs_state_published_widths(bench):
    cfgs = {c["name"]: json.loads((common.CHECKOUT / c["file"]).read_text())
            for c in bench["configs"]}
    r = cfgs["sequoia-resnet50-vis"]
    assert (r["backbone"]["feature_dim"], r["vis"]["depth"], r["vis"]["nheads"],
            r["vis"]["num_outputs"], r["kmeans"]["n_clusters"]) == (2048, 6, 16, 20820, 100)
    u = cfgs["sequoia-uni-vitl16-vis"]["backbone"]
    assert (u["feature_dim"], u["depth"], u["heads"], u["mlp_dim"], u["patch"],
            u["img_size"]) == (1024, 24, 16, 4096, 16, 224)
    for c in bench["configs"]:
        assert cfgs[c["name"]]["reduced"] == c["reduced"]
