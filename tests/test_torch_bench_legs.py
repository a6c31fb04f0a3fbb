"""The port's bench legs (``sequoia_tpu_torch/bench.py``) on the CPU at shrunk
constants (``--device cpu``: the plain PyTorch versions), as
``tests/test_bench_harness.py`` runs the JAX bench's spatial and Aperio legs:
each leg's numbers and audit, the e2e legs on native-written and on
Pillow-written fixtures, the mosaic guard, the legs that report themselves
absent without the native library, and ``main`` with every leg at once
against the JAX bench's key tree."""

import functools
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

from sequoia_tpu_torch import _build, bench, dryrun, native
from tests import torch_bench_schema as schema

# 64-px patches (48-px Aperio tiles: JPEG tiles are multiples of 16 and not
# the patch size) on a 6 x 6 grid: 384-px slides, about 24 candidates
SMALL = dict(PATCHES_PER_SLIDE=36, PATCH=64, APERIO_TILE=48, E2E_GRID=6, NUM_GENES=24,
             NUM_CLUSTERS=8, FEAT_BATCH=8, UNI_FEAT_BATCH=4, TIMED_SLIDES=1,
             SPATIAL_GRID=14, SPATIAL_FOLDS=2, TRAIN_BATCH=2,
             TRAIN_STEPS=2, EPOCH_SLIDES=6, DECODE_GRID=4)
TINY_UNI = dict(img_size=32, patch_size=16, dim=16, depth=2, heads=2, mlp_dim=32)


@pytest.fixture()
def small(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(bench, k, v)
    # every leg's ViS, shrunk through the helper that names its widths
    monkeypatch.setattr(dryrun, "entry_config", functools.partial(
        dryrun.entry_config, depth=1, nheads=2, head_dim=8))
    return monkeypatch


def tiny_uni(monkeypatch):
    """The default UNI ViT-L swapped for a tiny one (tests/test_torch_uni.py)."""
    from sequoia_tpu_torch.models import uni_vit

    cfg = uni_vit.UniViTConfig(**TINY_UNI)
    monkeypatch.setattr(uni_vit, "UniViTConfig", lambda **kw: cfg)


def no_native(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "build_error", lambda: "g++ failed: tiffio.h: No such file")


def assert_no_launches(res):
    assert set(res["launches"]) == set(_build.LAUNCHES) and not any(res["launches"].values())


def test_resnet_leg_smoke_cpu(small):
    res = bench.measure_device_pipeline("resnet", device="cpu")
    assert res["s_per_slide"] > 0
    assert_no_launches(res)  # the CPU runs the plain versions, kernels or not


def test_uni_leg_smoke_cpu(small):
    tiny_uni(small)
    res = bench.measure_device_pipeline("uni", device="cpu", kernels=False)
    assert res["s_per_slide"] > 0
    assert_no_launches(res)


def test_spatial_leg_smoke_cpu(small):
    """A window holds up to 100 tiles: the ViS keeps its 100 tokens."""
    small.setattr(bench, "FEAT_DIM", 16)
    small.setattr(bench, "NUM_CLUSTERS", 100)
    res = bench.measure_spatial(device="cpu")
    # windows of 10 x 10 tiles at stride 1 holding more than 50 of the 14 x 14 grid
    assert res["s_per_map"] > 0 and res["windows"] == 75
    assert_no_launches(res)


def test_train_leg_smoke_cpu(small):
    """The three timed parts and the host metric floor; the HE2RNA k sweep
    needs 100 tokens, so T stays 100 at a narrow D."""
    small.setattr(bench, "FEAT_DIM", 16)
    small.setattr(bench, "NUM_CLUSTERS", 100)
    res = bench.measure_train(device="cpu")
    for k in ("vis_step_ms", "vis_slides_per_sec", "vis_tflops", "vis_mfu_pct",
              "he2rna_step_ms", "epoch_slides_per_hour", "ref_host_metric_s_per_batch",
              "vs_ref_epoch"):
        assert np.isfinite(res[k]) and res[k] > 0, k
    assert_no_launches(res)


@pytest.mark.skipif(not native.available(), reason="native tiff library not built")
def test_e2e_legs_on_native_fixtures(small, tmp_path):
    """JPEG/YCbCr fixtures through the native reader: patch-size tiles take
    'ycbcr', 48-px tiles 'mosaic' (the leg's own guard), and demanding the
    mosaic of patch-size tiles raises."""
    res = bench.measure_e2e_serving(device="cpu", workdir=str(tmp_path))
    audit = res["audit"]
    assert res["s_per_slide"] > 0 and audit["reader"] == "native" and audit["mode"] == "ycbcr"
    assert audit["bytes_uploaded_per_slide_mb"] > 0
    assert audit["candidates_per_slide"] >= audit["kept_per_slide"] > bench.NUM_CLUSTERS
    assert audit["first_read_s"] > 0 and audit["steady_read_ms"] > 0
    assert_no_launches(res)
    ap = bench.measure_e2e_serving(device="cpu", workdir=str(tmp_path), tile=bench.APERIO_TILE,
                                   expect_mode="mosaic")
    assert ap["audit"]["mode"] == "mosaic" and ap["audit"]["reader"] == "native"
    assert ap["audit"]["kept_per_slide"] == audit["kept_per_slide"]
    with pytest.raises(RuntimeError, match="mosaic"):
        bench.measure_e2e_serving(device="cpu", workdir=str(tmp_path), expect_mode="mosaic")


def test_e2e_leg_on_pillow_fixtures(small, tmp_path):
    """Without the native library the fixtures are Pillow TIFFs, served in
    'rgb' through Pillow, and the audit names the reader; the Aperio leg
    reports itself absent with the build error."""
    from PIL import Image

    no_native(small)
    res = bench.measure_e2e_serving(device="cpu", workdir=str(tmp_path))
    audit = res["audit"]
    assert audit["reader"] == "pil" and audit["mode"] == "rgb"
    assert audit["candidates_per_slide"] >= audit["kept_per_slide"] > bench.NUM_CLUSTERS
    tiffs = sorted(tmp_path.glob("*.tiff"))
    assert len(tiffs) == 2
    with Image.open(tiffs[0]) as im:
        assert im.n_frames == 2 and im.size == (bench.E2E_GRID * bench.PATCH,) * 2
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), bench.e2e_levels(100)[0])
    with pytest.raises(bench.LegAbsent, match="tiffio.h"):
        bench.measure_e2e_serving(device="cpu", workdir=str(tmp_path), tile=bench.APERIO_TILE,
                                  expect_mode="mosaic")


def test_e2e_leg_takes_slide_readers(small):
    """Readers pass through to serving: an in-memory pyramid of the fixture."""
    from sequoia_tpu_torch.data.wsi import ArrayReader

    slides = [ArrayReader(bench.e2e_levels(100 + i)) for i in range(2)]
    res = bench.measure_e2e_serving(device="cpu", slides=slides)
    assert res["audit"]["reader"] == "ArrayReader" and res["audit"]["mode"] == "rgb"
    assert "first_read_s" not in res["audit"] and res["s_per_slide"] > 0


def test_decode_leg_absent_without_native(monkeypatch, tmp_path):
    no_native(monkeypatch)
    failures: dict = {}
    assert not bench.run_leg("decode", lambda: bench.measure_decode(str(tmp_path)), {},
                             failures)
    assert failures["decode"] == ("LegAbsent: native tiff reader unavailable: g++ failed: "
                                  "tiffio.h: No such file")


@pytest.mark.skipif(not native.available(), reason="native tiff library not built")
def test_decode_leg_rates_native(small, tmp_path):
    rates = bench.measure_decode(str(tmp_path))
    for k in ("raw", "jpeg", "jpeg_ycbcr", "jpeg240_patch_rgb", "jpeg240_mosaic_ycbcr",
              "jpeg422_ycbcr"):
        assert rates[k] > 0, k
    assert set(rates["thread_sweep_jpeg"]) == {1, 2, 4, 8}


def test_main_cpu_every_leg_one_line_matches_jax_key_tree(small, tmp_path):
    """``main --device cpu`` runs every leg at the shrunk constants: one
    JSON line, exit 0, and the key tree of the JAX bench fed the same leg
    results (less its relay and cache keys, plus device and launches)."""
    tiny_uni(small)
    small.setattr(bench, "NUM_CLUSTERS", 100)  # HE2RNA's k sweep, the spatial windows
    small.setattr(bench, "FEAT_DIM", 16)  # spatial and train; the backbones keep theirs
    small.chdir(tmp_path)
    seen: dict = {}

    def record(name, fn):
        def wrapped(*args, **kw):
            key = name(*args, **kw) if callable(name) else name
            seen[key] = fn(*args, **kw)
            return seen[key]
        return wrapped

    small.setattr(bench, "measure_probe", record("probe", bench.measure_probe))
    small.setattr(bench, "measure_device_pipeline",
                  record(lambda backbone, **kw: backbone, bench.measure_device_pipeline))
    small.setattr(bench, "measure_spatial", record("spatial", bench.measure_spatial))
    small.setattr(bench, "measure_train", record("train", bench.measure_train))
    small.setattr(bench, "measure_decode", record("decode", bench.measure_decode))
    small.setattr(bench, "measure_e2e_serving", record(
        lambda *a, backbone="resnet", expect_mode=None, **kw:
        "e2e_aperio" if expect_mode else "e2e" if backbone == "resnet" else "e2e_uni",
        bench.measure_e2e_serving))
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench.main(["--device", "cpu"])
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    out = json.loads(lines[0])
    failing = tuple(out.get("leg_failures", {}))
    if native.available():
        assert rc == 0 and not failing, out.get("leg_failures")
    else:
        assert rc == 0 and set(failing) == {"decode", "e2e_aperio"}, failing
    assert out["device"] == {"name": "cpu", "power_limit": None}
    assert set(out["launches"]) == set(seen) - {"probe", "decode"} - set(failing)
    assert np.isfinite(out["value"]) and out["value"] > 0
    jax_out = schema.run_jax_main(small, tmp_path, schema.jax_results_from_port(seen), failing)
    assert schema.port_tree(out) == schema.jax_tree(jax_out)
    assert list(tmp_path.iterdir()) == [tmp_path / "jax_bench_cache.json"]
