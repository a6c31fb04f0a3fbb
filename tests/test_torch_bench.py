"""The port's one module of H100 peak rates and ViS work counts
(``sequoia_tpu_torch/bench.py``): the training step's FLOP count against the
JAX bench's (``bench.py``), each rate against NVIDIA's data sheet and against
the benchmark harness's own copy (``benchmark/arith.py``), and each reader's
figure moving with the rate it divides by."""

import importlib.util
import pathlib

import pytest
import torch

from benchmark import arith
from sequoia_tpu_torch import bench

ROOT = pathlib.Path(__file__).resolve().parents[1]
# H100 SXM data sheet, dense rates (no sparsity), 700 W
DATA_SHEET = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12, "hbm": 3.35e12}


def load_jax_bench():
    spec = importlib.util.spec_from_file_location("sequoia_jax_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rate(route: str) -> float:
    return bench.HBM_BYTES_PER_S if route == "hbm" else bench.PEAK_FLOPS[route]


def test_vis_train_flops_equals_jax():
    """``_vis_train_flops`` at the production config and at a narrow one."""
    from sequoia_tpu.models import vis as jvis
    from sequoia_tpu_torch.models import vis as tvis

    jb = load_jax_bench()
    for kw, batch in ((dict(num_outputs=20820, input_dim=2048, depth=6, nheads=16, dim_f=64,
                            dim_s=64, dim_c=64, num_clusters=100), 16),
                      (dict(num_outputs=32, input_dim=96, depth=2, nheads=3, dim_f=8,
                            dim_s=16, dim_c=4, num_clusters=7), 3)):
        assert bench._vis_train_flops(tvis.ViSConfig(**kw), batch) == \
            jb._vis_train_flops(jvis.ViSConfig(**kw), batch)


@pytest.mark.parametrize("route", list(DATA_SHEET))
def test_rate_is_the_h100_sxm_data_sheet(route):
    assert set(bench.PEAK_FLOPS) == set(DATA_SHEET) - {"hbm"}
    assert rate(route) == DATA_SHEET[route]


@pytest.mark.parametrize("route", ["bfloat16", "tf32", "float32", "hbm"])
def test_port_rates_agree_with_the_harness(route):
    """The harness keeps its own copy; where the keys meet the two agree."""
    harness = arith.PEAK_BYTES_PER_S if route == "hbm" else arith.PEAK_FLOPS[route]
    assert rate(route) == harness


def _profile_backbone(monkeypatch, dtype: str, route: str, products: int):
    """Stage bounds of a tiny batch: with the route's peak at 1 FLOP/s every
    convolution stage is bound by its operations (``products`` products an
    operation: 3 for f32 as 3xTF32), and the mean (no FLOP) by its bytes at
    the HBM rate."""
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.tools import profile_backbone as pb

    cfg = pb.make_config(dtype)
    params = resnet.random_params(torch.Generator().manual_seed(0))
    u8 = torch.randint(0, 256, (1, 32, 32, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(1))
    outs = pb.staged_forward(cfg, params, u8)
    monkeypatch.setitem(bench.PEAK_FLOPS, route, 1.0)
    monkeypatch.setattr(bench, "HBM_BYTES_PER_S", 2.0)
    rows = pb.stage_bounds(cfg, params, u8, outs)
    for name in ("stem", "layer1", "layer4"):
        assert rows[name]["bound_by"] == "operations"
        assert rows[name]["bound_ms"] == pytest.approx(products * rows[name]["gflop"] * 1e9 * 1e3)
    assert rows["mean"]["bound_ms"] == pytest.approx(rows["mean"]["bytes"] / 2.0 * 1e3)


def _profile_train_step(monkeypatch):
    from sequoia_tpu_torch.models import vis
    from sequoia_tpu_torch.tools import profile_train_step as pts

    monkeypatch.setitem(bench.PEAK_FLOPS, "bfloat16", 2.0)
    monkeypatch.setattr(bench, "HBM_BYTES_PER_S", 4.0)
    res = pts.profile_vis(batch=2, tokens=4, dim=16, genes=6, depth=1, nheads=2, head_dim=4,
                          steps=1, device="cpu")
    cfg = vis.ViSConfig(num_outputs=6, input_dim=16, depth=1, nheads=2, dim_f=4, dim_s=4,
                        dim_c=4, num_clusters=4)
    flops = bench._vis_train_flops(cfg, 2)
    assert res["mxu_floor_ms"] == pytest.approx(flops / 2.0 * 1e3)
    assert res["mfu_pct_device"] == pytest.approx(
        flops / (res["full_step_device_ms"] / 1e3) / 2.0 * 100)
    assert res["head_fwd_floor_ms"] == pytest.approx(16 * 6 * 4 / 4.0 * 1e3)


def _chip_smoke(monkeypatch):
    import chip_smoke

    for route in ("float32", "tf32", "bfloat16"):
        monkeypatch.setitem(bench.PEAK_FLOPS, route, 2e9)
        assert chip_smoke.bound_ms(0, 4e9, route) == (pytest.approx(2000.0), "operations")
    monkeypatch.setattr(bench, "HBM_BYTES_PER_S", 1e9)
    assert chip_smoke.bound_ms(3e9, 0, "bfloat16") == (pytest.approx(3000.0), "bytes")


def _chip_smoke_3xtf32(monkeypatch):
    """A 3xTF32 kernel's row: three TF32 products an f32 product at ``tf32``,
    its f32 FMA bound on the CUDA cores at ``float32``, bytes at the HBM
    rate."""
    import chip_smoke

    monkeypatch.setitem(bench.PEAK_FLOPS, "tf32", 3e9)
    monkeypatch.setitem(bench.PEAK_FLOPS, "float32", 2e9)
    monkeypatch.setattr(bench, "HBM_BYTES_PER_S", 1e9)
    row = chip_smoke.kernel_bounds(5e8, 4e9, "float32", 8000.0, tf32=True)
    assert (row["bound_ms"], row["bound_by"]) == (pytest.approx(4000.0), "operations")
    assert row["bound_share"] == pytest.approx(0.5)
    assert row["bound_cuda_cores_ms"] == pytest.approx(2000.0)
    assert row["bound_bytes_ms"] == pytest.approx(500.0)


READERS = {
    "profile_backbone_bf16": lambda mp: _profile_backbone(mp, "bfloat16", "bfloat16", 1),
    "profile_backbone_f32": lambda mp: _profile_backbone(mp, "float32", "tf32", 3),
    "profile_train_step": _profile_train_step,
    "chip_smoke": _chip_smoke,
    "chip_smoke_3xtf32": _chip_smoke_3xtf32,
}


@pytest.mark.parametrize("site", list(READERS))
def test_reader_divides_by_the_one_rate(monkeypatch, site):
    """Each reader's figure follows the module's rate for its route when that
    rate is changed: no reader keeps a copy of its own."""
    READERS[site](monkeypatch)
