"""The yardstick's counts against hand counts and the program's own."""

from __future__ import annotations

import math

import pytest

from benchmark import arith


def test_resnet50_at_224_is_4_09_gmac():
    assert arith.resnet50_macs(224, 224, fc_classes=1000) == pytest.approx(4.09e9, rel=5e-3)
    assert arith.resnet50_params(fc_classes=1000) == 25_557_032  # torchvision resnet50


def test_resnet50_at_256_is_10_7_gflop():
    assert 2 * arith.resnet50_macs(256, 256) == pytest.approx(10.7e9, rel=5e-3)


def test_vit_l16_at_224_is_61_6_gmac():
    assert arith.vit_macs() == pytest.approx(61.6e9, rel=2e-3)
    assert arith.vit_params() == pytest.approx(303.3e6, rel=2e-3)  # timm, num_classes=0


def test_vis_train_flops_is_the_programs():
    from sequoia_tpu_torch import bench
    from sequoia_tpu_torch.models import vis

    cfg = vis.ViSConfig(num_outputs=20820, input_dim=2048)
    mine = arith.vis_train_flops(tokens=100, dim=2048, depth=6, heads=16, dim_f=64, dim_s=64,
                                 dim_c=64, genes=20820, batch=16)
    assert mine == bench._vis_train_flops(cfg, 16)
    blocks, head = arith.vis_forward_flops(100, 2048, 6, 16, 64, 64, 64, 20820)
    assert 3 * 16 * (blocks + head) == mine


def test_vis_params_count_the_programs_tree():
    import torch

    from sequoia_tpu_torch.models import vis

    cfg = vis.ViSConfig(num_outputs=40, input_dim=64, depth=2, nheads=2, dim_f=16, dim_s=16,
                        dim_c=16, num_clusters=8)
    p = vis.init(cfg, torch.Generator().manual_seed(0))
    n = sum(t.numel() for t in [p["pos_emb"], p["head_w"], p["head_b"], p["head_ln_scale"],
                                p["head_ln_bias"], *p["blocks"].values()])
    blocks, head = arith.vis_params(dim=64, depth=2, heads=2, dim_f=16, dim_s=16, dim_c=16,
                                    genes=40, tokens=8)
    assert blocks + head == n


def test_bound_takes_the_longer_of_compute_and_bytes():
    assert arith.bound_s({"bfloat16": 989e12}, 0) == pytest.approx(1.0)
    assert arith.bound_s({"float32": 67e9}, 3.35e12) == pytest.approx(1.0)
    assert arith.bound_s({"bfloat16": 989e12, "float32": 67e12}, 0) == pytest.approx(2.0)


def test_kmeans_work_counts_seeding_and_steps():
    fl, by = arith.kmeans_work(4000, 2048, 100, 20)
    assert fl["float32"] == 3 * 100 * 4000 * 2048 + 22 * 2 * 4000 * 100 * 2048
    assert by == 4000 * 2048 * 4 + 100 * 2048 * 4
    assert math.isclose(arith.bound_s(fl, by), fl["float32"] / 67e12)
