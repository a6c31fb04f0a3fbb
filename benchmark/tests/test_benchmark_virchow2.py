"""The backbone kind ``virchow2`` alone, at a CPU size: found through
``serving.backbone_kind``, its program extractor against its reference,
its ``work()`` against a count by hand, its cell correct untraced and
traced with the two ViT span metrics reported, and its control failing the
cell's limits."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import control, run, serving
from benchmark.tests import tiny
from benchmark.tests.test_benchmark_control import failed

CPU = torch.device("cpu")
CELL = "virchow2-vis.slides"
#: 2 blocks of 64 wide, 2 heads of 32, 4 registers, a packed fc1 of 342
#: (Virchow2's ratio 5.3375), 28-px input of 14-px patches from 32-px patches
TINY = {"backbone": {"patch_size": 32, "img_size": 28, "patch": 14, "dim": 64,
                     "feature_dim": 128, "depth": 2, "heads": 2, "mlp_dim": 342,
                     "batch_size": 4},
        "kmeans": {"n_clusters": 4},
        "vis": {"input_dim": 128, "depth": 1, "nheads": 2, "dim_f": 16, "dim_s": 16,
                "dim_c": 16, "num_outputs": 24, "num_clusters": 4}}
SEEDS = [3, 2 ** 31 + 17, 2 ** 32 + 5]


def spec() -> dict:
    s = tiny.spec(CELL)
    s["config"] = tiny.merge(s["config"], TINY)
    return s


def test_the_kind_is_found_and_its_extractor_follows_its_reference():
    s = spec()
    kind = serving.backbone_kind(s["config"])
    b = s["config"]["backbone"]
    params = serving.backbone_weights(s["config"], 5, CPU)
    assert params["reg_token"].shape == (4, 64) and params["pos_emb"].shape == (9, 64)
    assert params["blocks"]["w_fc2"].shape == (2, 171, 64)
    ext, on = kind.extractor(b, params, ["bottleneck_chain", "lloyd_stats"], CPU)
    assert on == ["lloyd_stats"] and ext.feature_dim == 128
    u8 = np.random.default_rng(0).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    want = kind.reference(b, params, u8, CPU, "float32")
    got = ext.features(u8)
    assert got.shape == want.shape == (6, 128)
    assert serving.feat_gap(got, want) < 0.03  # bf16, as the configuration states


def test_work_counts_by_hand():
    """One 28-px image of 14-px patches: 4 patches and 1 + 4 + 4 = 9 tokens,
    dim 64, fc1 342, fc2 171, 2 blocks."""
    b = spec()["config"]["backbone"]
    kind = serving.backbone_kind(spec()["config"])
    n, d, f, h = 9, 64, 342, 171
    embed = 4 * (14 * 14 * 3) * d
    block = n * d * 3 * d + 2 * n * n * d + n * d * d + n * d * f + n * h * d
    macs = embed + 2 * block
    assert kind.macs(b) == macs
    block_p = (2 * d + 3 * d * d + 3 * d + d * d + d + d + 2 * d + d * f + f + h * d + d + d)
    params = 14 * 14 * 3 * d + d + d + 4 * d + n * d + 2 * block_p + 2 * d
    assert kind.n_params(b) == params
    # 10 patches in batches of 4 run 12, the tail padded; bf16 weights once a batch
    flops, nbytes = kind.work(b, 10)
    assert flops == {"bfloat16": 2.0 * macs * 12}
    assert nbytes == 10 * 32 * 32 * 3 + 10 * 128 * 4 + 3 * params * 2


def test_the_full_size_work_is_the_issue_count():
    """At the published shapes a patch is ≈ 340 GFLOP (2.77 times UNI's)."""
    cfg = tiny.spec(CELL)["config"]
    kind = serving.backbone_kind(cfg)
    gflop = 2 * kind.macs(cfg["backbone"]) / 1e9
    assert 335 < gflop < 345
    assert 630e6 < kind.n_params(cfg["backbone"]) < 635e6


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_on_the_cpu(trace):
    from sequoia_tpu_torch.utils import profiling

    profiling.clear()
    result, checks = run.run_cell(spec(), seed=2 ** 33 + 5, seconds=0.5, trace=trace,
                                  device=CPU, t_start=time.perf_counter())
    profiling.clear()
    assert result["correct"], checks
    names = {c["name"] for c in checks}
    assert names == {"feat_gap", "genes_gap", "bad_answers"}
    if trace:
        # the device-trace shares read nothing on the CPU
        for key in ("vit_mlp_ms_per_kpatch", "vit_preprocess_ms_per_kpatch",
                    "backbone_ms_per_kpatch", "host_syncs_per_slide"):
            assert result["metrics"][key]["value"] > 0, key
    else:
        assert result["metrics"]["slides_per_hour"]["value"] > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_the_limits(seed):
    s = spec()
    r = control.serving_control(s, seed, CPU)
    assert failed(r, s["limits"]), r
