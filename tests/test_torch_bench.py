"""The port's bench harness (``sequoia_tpu_torch/bench.py``) against the
JAX bench's (``bench.py``, ``tests/test_bench_harness.py``): the leg
watchdog, the quarantine after a timed-out device leg, one JSON line and exit
1 when the headline leg fails with no cache anywhere, the JSON key tree
against the JAX bench's fed the same leg results, and the train leg's FLOP
count."""

import io
import json
import time
from contextlib import redirect_stdout

import pytest
import torch

from sequoia_tpu_torch import bench
from tests import torch_bench_schema as schema

ZERO = dict.fromkeys(("vis_blocks_fused", "stem16", "bottleneck_chain_cp",
                      "bottleneck_chain", "lloyd_stats"), 0)
TRAIN = {"vis_step_ms": 10.0, "vis_slides_per_sec": 1600.0, "vis_tflops": 50.0,
         "vis_mfu_pct": 25.0, "he2rna_step_ms": 5.0, "he2rna_slides_per_sec": 3200.0,
         "epoch_slides_per_hour": 90000.0, "ref_host_metric_s_per_batch": 2.0,
         "ref_step_s_modeled": 2.1, "vs_ref_epoch": 100.0}
DECODE = {"raw": 8000.0, "jpeg": 5000.0, "jpeg_ycbcr": 6000.0,
          "thread_sweep_jpeg": {1: 900.0, 8: 5000.0}, "jpeg240_patch_rgb": 3000.0,
          "jpeg240_mosaic_ycbcr": 4500.0, "jpeg422_ycbcr": 4000.0}
AUDIT = {"slides_timed": 2, "bytes_uploaded_per_slide_mb": 400.0, "effective_h2d_mbps": 90.0,
         "candidates_per_slide": 4300, "kept_per_slide": 4096, "decode_threads": 8,
         "host_cores": 8}


def port_results(launches=ZERO) -> dict:
    """Fake port leg results, in the port legs' return shapes."""
    return {"probe": {"name": "cpu", "power_limit": None, "h2d_mbps": 10.0},
            "resnet": {"s_per_slide": 2.0, "launches": dict(launches)},
            "uni": {"s_per_slide": 4.0, "launches": dict(launches)},
            "spatial": {"s_per_map": 20.0, "windows": 3969, "launches": dict(launches)},
            "train": {**TRAIN, "launches": dict(launches)},
            "decode": dict(DECODE),
            "e2e": {"s_per_slide": 10.0, "audit": dict(AUDIT), "launches": dict(launches)},
            "e2e_uni": {"s_per_slide": 20.0, "audit": dict(AUDIT), "launches": dict(launches)},
            "e2e_aperio": {"s_per_slide": 12.0, "audit": dict(AUDIT),
                           "launches": dict(launches)}}


def feed(monkeypatch, results: dict, failing=()) -> None:
    """Replace the port's legs by ``results`` (a leg in ``failing`` raises)."""
    def leg(name):
        def fn(*args, **kw):
            if name in failing:
                raise RuntimeError(f"{name} failed")
            return results[name]
        return fn

    monkeypatch.setattr(bench, "measure_probe", leg("probe"))
    monkeypatch.setattr(bench, "measure_device_pipeline",
                        lambda backbone, **kw: leg(backbone)())
    monkeypatch.setattr(bench, "measure_spatial", leg("spatial"))
    monkeypatch.setattr(bench, "measure_train", leg("train"))
    monkeypatch.setattr(bench, "measure_decode", leg("decode"))

    def e2e(h2d_mbps=None, backbone="resnet", slides=None, tile=None, expect_mode=None, **kw):
        return leg("e2e_aperio" if expect_mode == "mosaic"
                   else "e2e" if backbone == "resnet" else "e2e_uni")()

    monkeypatch.setattr(bench, "measure_e2e_serving", e2e)


def run_main(argv) -> tuple[list[str], int]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench.main(argv)
    return [ln for ln in buf.getvalue().splitlines() if ln.strip()], rc


def test_run_leg_reports_a_raising_leg():
    results: dict = {}
    failures: dict = {}
    ok = bench.run_leg("probe", lambda: (_ for _ in ()).throw(RuntimeError("card lost")),
                       results, failures)
    assert ok is False
    assert failures["probe"] == "RuntimeError: card lost"
    assert results == {}


def test_run_leg_reraises_keyboard_interrupt():
    def interrupted():
        raise KeyboardInterrupt

    failures: dict = {}
    with pytest.raises(KeyboardInterrupt):
        bench.run_leg("probe", interrupted, {}, failures)
    assert failures == {}


def test_run_leg_times_out_hung_leg(monkeypatch):
    monkeypatch.setitem(bench.LEG_TIMEOUTS, "probe", 1)
    results: dict = {}
    failures: dict = {}
    t0 = time.perf_counter()
    ok = bench.run_leg("probe", lambda: time.sleep(60), results, failures)
    assert ok is False
    assert time.perf_counter() - t0 < 10
    assert failures["probe"].startswith("LegTimeout")
    assert results == {}


def test_device_leg_timeout_quarantines_later_device_legs(monkeypatch, tmp_path):
    """A timed-out device leg leaves its thread on the device: every later
    device leg is skipped, the host-only decode leg still runs, and nothing
    stands in for the skipped legs."""
    monkeypatch.chdir(tmp_path)
    results = port_results()
    feed(monkeypatch, results)
    monkeypatch.setitem(bench.LEG_TIMEOUTS, "resnet", 1)
    monkeypatch.setattr(bench, "measure_device_pipeline", lambda backbone, **kw: time.sleep(60))
    for name in ("measure_spatial", "measure_train", "measure_e2e_serving"):
        monkeypatch.setattr(bench, name, lambda *a, _n=name, **kw: (_ for _ in ()).throw(
            AssertionError(f"{_n} must not run after a device-leg timeout")))
    lines, rc = run_main(["--device", "cpu"])
    assert len(lines) == 1 and rc == 1
    out = json.loads(lines[0])
    fails = out["leg_failures"]
    assert fails["resnet"].startswith("LegTimeout")
    for leg in ("uni", "spatial", "train", "e2e", "e2e_uni", "e2e_aperio"):
        assert fails[leg].startswith("skipped"), (leg, fails[leg])
        assert leg not in out["launches"]
    assert out["value"] is None and out["vs_baseline"] is None
    assert out["decode"]["jpeg"] == 5000.0
    for key in ("uni", "spatial", "train", "with_io", "with_io_uni", "with_io_aperio"):
        assert key not in out
    assert list(tmp_path.iterdir()) == []


def test_headline_failure_prints_one_line_exits_1_and_writes_no_cache(monkeypatch, tmp_path):
    """The resnet leg fails: one JSON line, exit 1, the other legs' fresh
    numbers in it, the failure under leg_failures, and no file written."""
    monkeypatch.chdir(tmp_path)
    feed(monkeypatch, port_results(), failing=("resnet",))
    lines, rc = run_main(["--device", "cpu"])
    assert len(lines) == 1 and rc == 1
    out = json.loads(lines[0])
    assert out["metric"] == "slides_per_hour_e2e_1chip" and out["value"] is None
    assert out["leg_failures"] == {"resnet": "RuntimeError: resnet failed"}
    assert "resnet failed" in out["unit"]
    assert out["uni"]["value"] == 900.0
    assert out["spatial"]["value"] == 180.0
    assert out["with_io"]["value"] == 360.0 and out["with_io_uni"]["value"] == 180.0
    assert out["decode"]["jpeg240_mosaic_ycbcr"] == 4500.0
    assert "resnet" not in out["launches"] and "uni" in out["launches"]
    assert "cached" not in out and "cache_reason" not in out
    assert list(tmp_path.iterdir()) == [] and not hasattr(bench, "CACHE")
    # every leg passing: exit 0
    feed(monkeypatch, port_results())
    lines, rc = run_main(["--device", "cpu"])
    assert len(lines) == 1 and rc == 0
    assert json.loads(lines[0])["value"] == 1800.0


@pytest.mark.parametrize("failing", [(), ("decode",), ("uni", "e2e_aperio")],
                         ids=["all_legs", "decode_fails", "uni_and_aperio_fail"])
def test_json_key_tree_matches_the_jax_bench(monkeypatch, tmp_path, failing):
    """Both benches fed the same leg results: the port's key tree is the JAX
    bench's less its relay and cache keys, plus ``device`` and
    ``launches``."""
    monkeypatch.chdir(tmp_path)
    results = port_results(launches={**ZERO, "lloyd_stats": 3})
    feed(monkeypatch, results, failing)
    lines, rc = run_main(["--device", "cpu"])
    assert len(lines) == 1 and rc == 0
    port = json.loads(lines[0])
    jax_out = schema.run_jax_main(monkeypatch, tmp_path, schema.jax_results_from_port(results),
                                  failing)
    assert schema.port_tree(port) == schema.jax_tree(jax_out)
    assert set(port["device"]) == {"name", "power_limit"}
    assert port["launches"] == {leg: results[leg]["launches"] for leg in results
                                if "launches" in results[leg] and leg not in failing}
    assert set(port.get("leg_failures", {})) == set(failing)
    # the same numbers where the units agree
    for key in ("uni", "spatial", "with_io", "with_io_uni", "with_io_aperio"):
        if key in jax_out:
            assert port[key]["value"] == jax_out[key]["value"], key
    assert port["value"] == jax_out["value"]
    assert port["train"]["he2rna_step_ms"] == jax_out["train"]["he2rna_step_ms"]
    assert port["with_io"]["audit"] == jax_out["with_io"]["audit"]


def test_vis_train_flops_equals_jax():
    """``_vis_train_flops`` at the production config and at a narrow one."""
    from sequoia_tpu.models import vis as jvis
    from sequoia_tpu_torch.models import vis as tvis

    jb = schema.load_jax_bench()
    for kw, batch in ((dict(num_outputs=20820, input_dim=2048, depth=6, nheads=16, dim_f=64,
                            dim_s=64, dim_c=64, num_clusters=100), 16),
                      (dict(num_outputs=32, input_dim=96, depth=2, nheads=3, dim_f=8,
                            dim_s=16, dim_c=4, num_clusters=7), 3)):
        assert bench._vis_train_flops(tvis.ViSConfig(**kw), batch) == \
            jb._vis_train_flops(jvis.ViSConfig(**kw), batch)
    assert bench._vis_train_flops(bench._vis_cfg(bench.FEAT_DIM), bench.TRAIN_BATCH) == \
        jb._vis_train_flops(jvis.ViSConfig(
            num_outputs=jb.NUM_GENES, input_dim=jb.FEAT_DIM, depth=6, nheads=16, dim_f=64,
            dim_s=64, dim_c=64, num_clusters=jb.NUM_CLUSTERS), jb.TRAIN_BATCH)


def test_constants_match_the_jax_bench():
    """The JAX bench's constants, less the two that change on the H100."""
    jb = schema.load_jax_bench()
    for name in ("PATCHES_PER_SLIDE", "PATCH", "FEAT_BATCH", "NUM_CLUSTERS", "NUM_GENES",
                 "FEAT_DIM", "TIMED_SLIDES", "SPATIAL_GRID", "SPATIAL_FOLDS", "E2E_GRID",
                 "E2E_JPEG_Q", "APERIO_TILE", "TRAIN_BATCH", "TRAIN_STEPS", "EPOCH_SLIDES",
                 "LEG_TIMEOUTS", "REF_SLIDES_PER_HOUR", "REF_UNI_SLIDES_PER_HOUR",
                 "REF_SPATIAL_MAPS_PER_HOUR", "REF_GPU_EFFECTIVE_FLOPS"):
        assert getattr(bench, name) == getattr(jb, name), name
    assert bench.H100_BF16_PEAK == 989e12 and not hasattr(bench, "V5E_BF16_PEAK")
    assert bench.UNI_FEAT_BATCH == 128
    cfg = bench._vis_cfg(bench.FEAT_DIM, "bfloat16")
    assert (cfg.num_outputs, cfg.input_dim, cfg.depth, cfg.nheads, cfg.dim_f, cfg.dim_s,
            cfg.dim_c, cfg.num_clusters, cfg.compute_dtype) == \
        (20820, 2048, 6, 16, 64, 64, 64, 100, "bfloat16")
    assert set(bench.LEGS) | {"probe"} == set(bench.LEG_TIMEOUTS)


def test_runs_on_cuda_unless_asked(monkeypatch):
    """No CUDA: the bench raises before any leg unless given --device cpu,
    and a leg called without a device raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(bench, "run_bench", lambda *a, **k: called.append(a) or ({}, 0, {}))
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--device", "cuda"])
    assert called == []
    assert run_main(["--device", "cpu"]) == (["{}"], 0)
    for leg in (lambda: bench.measure_device_pipeline("resnet"), bench.measure_spatial,
                bench.measure_train, lambda: bench.measure_e2e_serving(slides=["x.tiff"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            leg()
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--legs", "resnet,nope"])
