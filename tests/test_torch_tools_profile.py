"""The port's profilers (``sequoia_tpu_torch/tools/profile_backbone.py``,
``profile_train_step.py``) on the CPU at small sizes: each stage of the
staged ResNet-50 forward against the JAX tool's ``build_prefix`` on the same
weights (``tools/profile_backbone.py:29``), under every kernel setting the
tool times; the JSON's rows and bounds; every key of the JAX train-step
profile, finite, with the FLOP and byte floors against a hand count."""

import json
import math

import numpy as np
import pytest
import torch

import jax

from sequoia_tpu.models import resnet as jresnet
from sequoia_tpu_torch.models import convert, vis
from sequoia_tpu_torch.tools import profile_backbone as pb
from sequoia_tpu_torch.tools import profile_train_step as pts
from tools import profile_backbone as jpb


def jax_resnet_params(seed: int):
    """JAX ResNet-50 weights in ``random_params``' layout (traced, not run:
    quicker), filled from a numpy seed: He-normal HWIO kernels and a
    non-trivial folded BN; the s2d stem folded from ``conv1``."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        key = path[-1].key
        if key == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if key == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(jresnet.random_params, jax.random.PRNGKey(0)))
    params.pop("conv1_s2d")
    return jresnet.enable_s2d_stem(params)


@pytest.fixture(scope="module")
def weights():
    """JAX ResNet-50 weights, the port's copy of them and one batch of 2
    patches of 128 px (the layer4 map under 7x7, so both tools' last stage is
    the global mean)."""
    jparams = jax_resnet_params(0)
    tparams = convert.resnet_params_from_numpy(jax.tree.map(np.asarray, jparams))
    u8 = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    jcfg = jresnet.ResNetConfig(compute_dtype=jax.numpy.float32)
    prefixes = jax.jit(lambda p, v: tuple(jpb.build_prefix(jcfg, p, upto)(v)
                                          for upto in pb.STAGES))(jparams, u8)
    return tparams, u8, {upto: np.asarray(y) for upto, y in zip(pb.STAGES, prefixes)}


@pytest.mark.parametrize("setting", [
    {}, {"early_pallas": True}, {"early_pallas": True, "cp": (2, 3, 4)},
    {"fused": (1, 2, 3, 4)}], ids=["plain", "early_pallas", "early_pallas+cp", "fused"])
def test_stage_outputs_match_jax_build_prefix(weights, setting):
    tparams, u8, want = weights
    cfg = pb.make_config("float32", **setting)
    got = pb.staged_forward(cfg, tparams, torch.as_tensor(u8))
    names = ([pb.EARLY] if setting.get("early_pallas") else ["stem", "pool", "layer1"]) + \
        ["layer2", "layer3", "layer4", "mean"]
    assert list(got) == names
    for name, y in got.items():
        y = y.detach().numpy()
        ref = want["layer1" if name == pb.EARLY else name]
        if y.ndim == 4:
            y = y.transpose(0, 2, 3, 1)  # NCHW -> the JAX NHWC
        np.testing.assert_allclose(y, ref, rtol=2e-4, atol=1e-2, err_msg=name)


def test_stage_bounds_hand_count(weights):
    tparams, u8, _ = weights
    cfg = pb.make_config("bfloat16")
    outs = pb.staged_forward(cfg, tparams, torch.as_tensor(u8))
    rows = pb.stage_bounds(cfg, tparams, torch.as_tensor(u8), outs)
    # the stem: a 7x7/s2 conv 3 -> 64 onto 64 x 64, uint8 in, bf16 out
    stem_flop = 2 * 2 * 64 * 64 * 64 * 3 * 49
    stem_bytes = 2 * 128 * 128 * 3 + 2 * 64 * 64 * 64 * 2 + 64 * 3 * 49 * 2 + 2 * 64 * 4
    assert rows["stem"]["gflop"] == pytest.approx(stem_flop / 1e9)
    assert rows["stem"]["bytes"] == stem_bytes
    assert rows["stem"]["bound_ms"] == pytest.approx(
        max(stem_bytes / 3.35e12, stem_flop / 989e12) * 1e3)
    # layer4: 1024 x 8 x 8 in, 2048 x 4 x 4 out; the mean moves bytes only
    l4 = tparams["layer4"]
    flop = (2 * 2 * 8 * 8 * 512 * 1024 + 2 * 2 * 4 * 4 * 512 * 512 * 9
            + 2 * 2 * 4 * 4 * 2048 * 512 + 2 * 2 * 4 * 4 * 2048 * 1024
            + 2 * (2 * 2 * 4 * 4 * (2048 * 512 + 512 * 512 * 9 + 512 * 2048)))
    assert len(l4) == 3 and rows["layer4"]["gflop"] == pytest.approx(flop / 1e9)
    assert rows["mean"]["gflop"] == 0 and rows["mean"]["bound_by"] == "bytes"
    f32 = pb.stage_bounds(pb.make_config("float32"), tparams, torch.as_tensor(u8),
                          pb.staged_forward(pb.make_config("float32"), tparams,
                                            torch.as_tensor(u8)))
    # f32 as 3xTF32: three TF32 products at 495 TFLOP/s
    assert f32["layer3"]["bound_ms"] >= f32["layer3"]["gflop"] * 1e9 * 3 / 495e12 * 1e3


@pytest.mark.parametrize("setting,names", [
    ({}, ["stem", "pool", "layer1", "layer2", "layer3", "layer4", "mean"]),
    ({"early_pallas": True, "cp": (2, 3, 4)}, [pb.EARLY, "layer2", "layer3", "layer4", "mean"])],
    ids=["plain", "early_pallas+cp"])
def test_profile_json_has_every_row_and_bound(capsys, setting, names):
    argv = ["--batch", "2", "--iters", "1", "--dtype", "float32", "--device", "cpu"]
    if setting:
        argv += ["--early_pallas", "--cp", "2,3,4"]
    pb.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert list(res["stages"]) == names
    for name, row in res["stages"].items():
        for key in ("ms", "bytes", "gflop", "bound_ms", "bound_by", "bound_share",
                    "share_of_forward"):
            assert key in row, (name, key)
        assert row["bound_ms"] > 0 and math.isfinite(row["ms"]) and row["ms"] > 0
    assert res["forward_ms"] > 0 and res["patches_per_s"] > 0
    assert res["stages_sum_ms"] == pytest.approx(sum(r["ms"] for r in res["stages"].values()))
    assert res["bound_ms"] == pytest.approx(sum(r["bound_ms"] for r in res["stages"].values()))
    assert res["features"] == [2, 2048]  # the top-left AvgPool2d(7) window of the 8x8 map
    assert set(res["launches_per_forward"]) == {"vis_blocks_fused", "stem16",
                                                "bottleneck_chain_cp", "bottleneck_chain",
                                                "lloyd_stats"}
    assert not any(res["launches_per_forward"].values())  # the CPU runs the plain versions
    assert (res["fold_ms"] > 0) == bool(setting)
    assert "not measured" in res["trace"] and res["device"] == "cpu"


def test_kernel_classes():
    cases = {
        "void (anonymous namespace)::stem_wgmma_kernel<128>(bf16 const*)": "K2 stem16",
        "stem_tf32_kernel(float const*)": "K2 stem16",
        "void pc_wgmma_kernel<128>(WgArgs<bf16>)": "K3/K4 conv_wgmma",
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw": "cuDNN convolution",
        "void cudnn::ops::nchwToNhwcKernel<float>(...)": "layout copies and casts",
        "void at::native::elementwise_kernel<128, 2, direct_copy_kernel_cuda>": (
            "layout copies and casts"),
        "void at::native::vectorized_elementwise_kernel<4, MulFunctor<float> >": "BN scale",
        "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float> >": (
            "BN shift, residual adds"),
        "void at::native::vectorized_elementwise_kernel<4, clamp_min_scalar_kernel_cuda>": "ReLU",
        "void at::native::max_pool_forward_nchw<float, float>": "max pool, mean",
    }
    for name, want in cases.items():
        assert pb.kernel_class(name) == want, name


def test_entry_points_need_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.run(batch=1, iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        pts.profile_vis(batch=1, tokens=2, dim=8, genes=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pts.profile_he2rna(batch=1, tokens=2, dim=8, genes=2, ks=(1,))


# ---------------------------------------------------------------------------
# profile_train_step

# the JAX tool's keys (tools/profile_train_step.py:96-320)
VIS_KEYS = ("n_params_m", "fwd_ms", "blocks_fwd_ms", "head_fwd_ms", "head_fwd_floor_ms",
            "fwd_bwd_ms", "adamw_ms", "adamw_floor_ms", "adamw_traffic_mb", "adamw_bf16_ms",
            "adamw_bf16_floor_ms", "metrics_ms", "full_step_device_ms",
            "full_step_bf16moments_device_ms", "full_step_dispatched_ms", "flops_tf",
            "mxu_floor_ms", "mfu_pct_device")
HE2RNA_KEYS = ("per_k_ms", "uniform_mixture_ms", "random_k_device_ms", "bwd_onehot_tf_at_k")


def test_profile_vis_keys_and_floors():
    shape = dict(batch=3, tokens=6, dim=64, genes=10, depth=2, nheads=2, head_dim=16)
    res = pts.profile_vis(**shape, steps=2, device="cpu")
    assert set(res) == set(VIS_KEYS)
    assert all(math.isfinite(v) and v >= 0 for v in res.values())
    cfg = vis.ViSConfig(num_outputs=10, input_dim=64, depth=2, nheads=2, dim_f=16, dim_s=16,
                        dim_c=16, num_clusters=6)
    n = sum(t.numel() for t in
            (lambda p: [p["pos_emb"], p["head_ln_scale"], p["head_ln_bias"], p["head_w"],
                        p["head_b"], *p["blocks"].values()])(
                vis.init(cfg, torch.Generator().manual_seed(0))))
    assert res["n_params_m"] == round(n / 1e6, 2)
    # by hand: per token and block the f and s projections (64 -> 2 x 2 x 16),
    # the combine (2 heads x 32 -> 16), the output projection (32 -> 64), the
    # FeedForward (two 64 x 64); then the head 64 -> 10; the backward twice
    per_block = 6 * (2 * 64 * 2 * 32 + 2 * 2 * 32 * 16 + 2 * 32 * 64 + 4 * 64 * 64)
    flops = 3 * (2 * per_block + 2 * 64 * 10) * 3
    assert pts.vis_train_flops(cfg, 3) == flops
    assert res["mxu_floor_ms"] == pytest.approx(flops / 989e12 * 1e3)
    assert res["head_fwd_floor_ms"] == pytest.approx(64 * 10 * 4 / 3.35e12 * 1e3)
    assert res["adamw_floor_ms"] == pytest.approx(28 * n / 3.35e12 * 1e3)
    assert res["adamw_bf16_floor_ms"] == pytest.approx(20 * n / 3.35e12 * 1e3)
    assert res["adamw_traffic_mb"] == round(28 * n / 1e6, 1)


def test_profile_he2rna_keys_and_floors():
    res = pts.profile_he2rna(batch=2, tokens=100, dim=16, genes=10, steps=1, device="cpu")
    assert set(res) == set(HE2RNA_KEYS)
    assert list(res["per_k_ms"]) == list(pts.HE2RNA_KS)
    assert all(math.isfinite(v) and v > 0 for v in res["per_k_ms"].values())
    assert res["uniform_mixture_ms"] == pytest.approx(np.mean(list(res["per_k_ms"].values())),
                                                      abs=1e-3)
    assert math.isfinite(res["random_k_device_ms"])
    assert res["bwd_onehot_tf_at_k"] == {k: round(2 * 2 * 10 * k * 100 / 1e12, 3)
                                         for k in pts.HE2RNA_KS}
