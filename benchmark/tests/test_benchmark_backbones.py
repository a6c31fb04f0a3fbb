"""Each backbone kind is a file of ``benchmark/backbones/``, found by the
configuration's ``backbone.kind`` (``serving.backbone_kind``).

``backbone_pins.json`` holds what the harness gave before the kinds were
files, at the tiny sizes of ``tiny.py`` on one CPU thread, for both kinds
and two seeds: a digest of each seeded weight tree, each row's norm and
its product with a fixed ramp for the reference features in each mode and
for the stored-feature pool, each slide's work at the tiny and the full
sizes, and the serving control's readings.  A new kind, a copy of UNI's
file, then comes in by new files and entries alone."""

from __future__ import annotations

import ast
import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from benchmark import common, control, run, serving
from benchmark.reference.train import leaves
from benchmark.tests import tiny
from benchmark.tests.test_benchmark_control import failed
from benchmark.tests.test_benchmark_extend import digest

PINS = json.loads(Path(__file__).with_name("backbone_pins.json").read_text())
CPU = torch.device("cpu")
SEEDS = [7, 2 ** 31 + 11]
CELLS = {"resnet50": "resnet50-vis.slides", "uni_vitl16": "uni-vis.slides"}
SERVING = ["resnet50-vis.slides", "uni-vis.slides", "resnet50-vis.features"]


@pytest.fixture(autouse=True)
def one_thread():
    """The pins were taken on one thread: more split the CPU's sums
    another way, and the fp8 control moves with the last bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree_digest(tree) -> str:
    h = hashlib.sha256()
    for t in leaves(tree):
        h.update(repr((tuple(t.shape), str(t.dtype))).encode())
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def rows(f) -> list:
    """Each row's norm and its product with a ramp from -1 to 1."""
    f = torch.as_tensor(f).double()
    w = torch.linspace(-1.0, 1.0, f.shape[1], dtype=torch.float64)
    return [[float(r.norm()), float(r @ w)] for r in f]


def flat(pairs: list) -> list:
    return [x for pair in pairs for x in pair]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", list(CELLS))
def test_weights_are_the_pinned(kind, seed):
    cfg = tiny.spec(CELLS[kind])["config"]
    assert tree_digest(serving.backbone_weights(cfg, seed, CPU)) == PINS["weights"][
        f"{kind}/{seed}"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", list(CELLS))
def test_reference_features_are_the_pinned(kind, seed):
    cfg = tiny.spec(CELLS[kind])["config"]
    w = serving.backbone_weights(cfg, seed, CPU)
    u8 = serving.patch_pool(seed, 6, cfg["backbone"]["patch_size"], CPU)
    for mode in ("float32", "tf32", "fp8"):
        got = rows(serving.reference_features(cfg, w, u8, CPU, mode, block=4))
        pin = PINS["features"][f"{kind}/{seed}/{mode}"]
        assert flat(got) == pytest.approx(flat(pin), rel=1e-6), mode


@pytest.mark.parametrize("seed", SEEDS)
def test_feature_pool_is_the_pinned(seed):
    cfg = tiny.spec("resnet50-vis.features")["config"]
    got = rows(serving.feature_pool(cfg, seed, 10, CPU, "tf32", chunk=4))
    assert flat(got) == pytest.approx(flat(PINS["pool"][str(seed)]), rel=1e-6)


@pytest.mark.parametrize("kind", list(CELLS))
def test_slide_work_is_the_pinned(kind):
    sizes = {"tiny": tiny.spec(CELLS[kind])["config"],
             "full": common.spec(common.CHECKOUT / "BENCHMARK.json", CELLS[kind])["config"]}
    for name, cfg in sizes.items():
        for n in (1, 7, 4000):
            for bb in (True, False):
                got = json.loads(json.dumps(serving.slide_work(cfg, n, 3, bb)))
                assert got == PINS["work"][f"{kind}/{name}/{n}/{bb}"], (name, n, bb)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", SERVING)
def test_serving_control_is_the_pinned(cell, seed):
    got = control.serving_control(tiny.spec(cell), seed, CPU)
    assert got == pytest.approx(PINS["control"][f"{cell}/{seed}"], rel=1e-6)


def _code_strings(path: Path) -> set:
    """The string constants of a module's code, docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs}


@pytest.mark.parametrize("name", ["serving.py", "control.py"])
def test_serving_and_control_name_no_kind(name):
    kinds = {p.stem for p in serving.BACKBONES.glob("*.py")}
    assert kinds >= set(CELLS)
    assert not {s for s in _code_strings(common.ROOT / name) if any(k in s for k in kinds)}


def test_a_kind_without_a_file_is_refused():
    cfg = tiny.merge(tiny.spec("uni-vis.slides")["config"], {"backbone": {"kind": "vit_none"}})
    with pytest.raises(ValueError, match="vit_none"):
        serving.backbone_kind(cfg)


# ------------------------------------------------ a kind added by new files

NEW = "dummy-vit.slides"


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    """A copy of the benchmark with backbone kind ``dummy_vit`` (a copy of
    UNI's file), its configuration, a cell on the ``slides`` mix and its
    limits: new files, and new entries in ``BENCHMARK.json``.  Returns the
    copy's root and the digest of its files from before the additions."""
    root = tmp_path_factory.mktemp("added")
    shutil.copytree(common.ROOT, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(common.CHECKOUT / "BENCHMARK.json", root / "BENCHMARK.json")
    b = root / "benchmark"
    before = digest(b)
    shutil.copy(b / "backbones" / "uni_vitl16.py", b / "backbones" / "dummy_vit.py")
    cfg = json.loads((b / "configs" / "sequoia-uni-vitl16-vis.json").read_text())
    cfg["name"], cfg["backbone"]["kind"] = "dummy-vit-vis", "dummy_vit"
    (b / "configs" / "dummy-vit-vis.json").write_text(json.dumps(cfg))
    shutil.copy(b / "limits" / "uni-vis.slides.json", b / "limits" / f"{NEW}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-vit-vis", "source": "a test",
                             "file": "benchmark/configs/dummy-vit-vis.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": NEW, "config": "dummy-vit-vis", "traffic": "slides",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "uni-vis.slides" in m.get("workloads", []):
            m["workloads"].append(NEW)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, before


def added_spec(root: Path, monkeypatch) -> dict:
    monkeypatch.setattr(serving, "BACKBONES", root / "benchmark" / "backbones")
    s = common.spec(root / "BENCHMARK.json", NEW)
    s["config"] = tiny.merge(s["config"], tiny.TINY["sequoia-uni-vitl16-vis"])
    s["traffic"] = tiny.merge(s["traffic"], tiny.TINY_TRAFFIC["slides"])
    return s


def test_new_kind_changes_no_file_that_was_there(added, monkeypatch):
    root, before = added
    after = digest(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
    kind = serving.backbone_kind(added_spec(root, monkeypatch)["config"])
    assert Path(kind.__file__) == root / "benchmark" / "backbones" / "dummy_vit.py"


def calls_of(kind, monkeypatch) -> list:
    """The names of the kind's four functions, each time one is called."""
    calls = []
    for name in ("weights", "extractor", "reference", "work"):
        fn = getattr(kind, name)
        monkeypatch.setattr(kind, name, lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a))
    return calls


@pytest.mark.parametrize("trace, metric", [(False, "slides_per_hour"),
                                           (True, "backbone_ms_per_kpatch")])
def test_new_kind_cell_runs_correct(added, monkeypatch, trace, metric):
    """A run of the new cell goes through the new file's functions (its
    ``work`` in the traced run, for the backbone's roofline on the card)
    and is correct."""
    s = added_spec(added[0], monkeypatch)
    calls = calls_of(serving.backbone_kind(s["config"]), monkeypatch)
    result, checks = run.run_cell(s, seed=2 ** 31 + 23, seconds=0.5, trace=trace, device=CPU,
                                  t_start=time.perf_counter())
    assert result["correct"] is True, checks
    assert metric in result["metrics"]
    assert set(calls) == {"weights", "extractor", "reference"} | ({"work"} if trace else set())


def test_new_kind_control_fails(added, monkeypatch):
    s = added_spec(added[0], monkeypatch)
    r = control.serving_control(s, 2 ** 31 + 23, CPU)
    assert failed(r, s["limits"]), r
