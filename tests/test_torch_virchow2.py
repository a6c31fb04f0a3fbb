"""The port's Virchow2 backbone (``models/uni_vit.py`` with
``Virchow2Config``) against the benchmark's plain reference
(``benchmark/reference/virchow2.py``: plain torch in f32, Pillow's bicubic
resize) on the CPU, at a tiny size that keeps every mechanism: 2 blocks of
width 160, 2 heads of 80 (a scale that is not a power of two), 4 register
tokens, a packed SwiGLU fc1 of 854 (Virchow2's ratio 5.3375), 28-px images
of 14-px patches.  Virchow2 has no JAX counterpart.

Also: planted faults that the comparison must fail, the bicubic resize
against Pillow, the timm state-dict loader, the serving entry points with
``feat_type="virchow2"``, UNI's forward pinned bit for bit to what it was
before Virchow2 joined its module, and the spans ``vit.mlp``,
``vit.preprocess`` and ``vit.attn`` with the benchmark readers of them."""

import dataclasses
import hashlib
import pickle

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import common
from benchmark import run as bench_run
from benchmark.reference import virchow2 as ref
from sequoia_tpu_torch.cli import serve as tcli
from sequoia_tpu_torch.cli.compute_features import load_extractor
from sequoia_tpu_torch.models import uni_vit as tuni
from sequoia_tpu_torch.models import vis as tvis
from sequoia_tpu_torch.ops import pil_resize
from sequoia_tpu_torch.pipeline import fused as tfused
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.serve import SlidePredictor
from sequoia_tpu_torch.train import checkpoint
from sequoia_tpu_torch.utils import profiling

TINY = dict(img_size=28, patch_size=14, dim=160, depth=2, heads=2, mlp_dim=854)
#: f32: both sides in IEEE f32 with other summation orders (addmm against
#: matmul + bias, F.layer_norm against mean and variance), so rounding alone
F32_TOL = 1e-5
#: bf16: each GEMM's output and the residual stream rounded to 8 bits
#: (2^-9 ≈ 2e-3 a rounding) through 2 blocks, the gate rounded twice; the
#: program reads 0.0098-0.0121 on these inputs (4 seeds), the reference's
#: fp8 e4m3 mode (3 bits, the step below) 0.105-0.147: the limit leaves
#: room of 2.5 times above the one and 3.5 times below the other
BF16_TOL = 0.03


def _cfg(dt=torch.float32, **kw) -> tuni.Virchow2Config:
    return tuni.Virchow2Config(**dict(TINY, **kw), compute_dtype=dt)


def _params(seed: int = 0, cfg=None) -> dict:
    return tuni.random_params(cfg or _cfg(), torch.Generator().manual_seed(seed),
                              layer_scale=0.1)


def _u8(n: int, size: int = 40, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _reference(params, u8, mode="float32") -> torch.Tensor:
    return ref.features(params, u8, img=TINY["img_size"], patch=TINY["patch_size"],
                        heads=TINY["heads"], device="cpu", mode=mode)


def _gap(got, want) -> float:
    """The widest row gap ``|got - want| / |want|`` (the benchmark's ``feat_gap``)."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())


def _program(u8, dt=torch.float32, cfg=None, params=None) -> torch.Tensor:
    cfg = cfg or _cfg(dt)
    params = tuni.prepare(cfg, params if params is not None else _params())
    with torch.no_grad():
        return tuni.extract_from_uint8(cfg, params, torch.as_tensor(u8))


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_config_preset_and_shapes():
    cfg = tuni.Virchow2Config()
    assert (cfg.img_size, cfg.patch_size, cfg.dim, cfg.depth, cfg.heads, cfg.mlp_dim,
            cfg.reg_tokens) == (224, 14, 1280, 32, 16, 6832, 4)
    assert (cfg.tokens, cfg.dim_head, cfg.hidden_dim, cfg.feature_dim) == (261, 80, 3416, 2560)
    assert (cfg.mlp, cfg.ln_eps, cfg.pool, cfg.resize) == ("swiglu_packed", 1e-6, "cls_mean",
                                                         "bicubic")
    uni = tuni.UniViTConfig()
    assert (uni.tokens, uni.hidden_dim, uni.feature_dim, uni.ln_eps, uni.resize) == (
        197, 4096, 1024, 1e-5, "bilinear")
    with pytest.raises(ValueError, match="even mlp_dim"):
        tuni.Virchow2Config(mlp_dim=855)
    with pytest.raises(ValueError, match="pool"):
        tuni.UniViTConfig(pool="mean")


def test_forward_f32_matches_the_reference():
    u8 = _u8(3)
    got = _program(u8)
    assert got.shape == (3, 320) and got.dtype == torch.float32
    assert _gap(got, _reference(_params(), u8)) <= F32_TOL


def test_feature_extractor_virchow2_matches_the_reference():
    """``FeatureExtractor("virchow2")`` in batches of 2 with the tail padded,
    f32 and bf16 (bf16 within :data:`BF16_TOL`, which the reference's fp8
    mode fails)."""
    u8 = _u8(5, seed=2)
    want = _reference(_params(), u8)
    for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        ext = FeatureExtractor("virchow2", _params(), batch_size=2, cfg=_cfg(dt), device="cpu",
                               patch_size=40)
        assert ext.feature_dim == 320 and ext.feat_type == "virchow2"
        got = ext.features(u8)
        assert got.shape == (5, 320) and got.dtype == torch.float32
        assert _gap(got, want) <= tol, dt
    assert _gap(_reference(_params(), u8, "fp8"), want) > BF16_TOL


def test_forward_bf16_within_its_tolerance_and_fp8_fails_it():
    u8 = _u8(4, seed=3)
    want = _reference(_params(), u8)
    assert _gap(_program(u8, torch.bfloat16), want) <= BF16_TOL
    assert _gap(_reference(_params(), u8, "fp8"), want) > BF16_TOL


def _gate_swapped(h):
    a, b = h.chunk(2, dim=-1)
    return a * F.silu(b)


def _registers_in_mean(cfg, y):
    y = y.float()
    return torch.cat([y[:, 0], y[:, 1:].mean(1)], dim=-1)


def _final_ln_on_cls_only():
    """A ``_residual`` whose final norm (the last of a forward's 2 * depth
    residuals) reaches the CLS row alone: the patch tokens go to the pool
    unnormalised."""
    calls, plain = [], tuni._residual

    def residual(x, out, gamma, ln, eps):
        xs, y = plain(x, out, gamma, ln, eps)
        calls.append(1)
        if len(calls) % (2 * TINY["depth"]) == 0:
            y = torch.cat([y[:, :1], xs[:, 1:]], dim=1)
        return xs, y

    return residual


@pytest.mark.parametrize("fault", ["gate_swapped", "registers_in_mean", "final_ln_cls_only",
                                   "bilinear"])
def test_planted_faults_fail(monkeypatch, fault):
    """Each fault of the block, the pooling or the preprocessing moves the
    features past both tolerances."""
    u8 = _u8(3, seed=4)
    cfg = _cfg()
    if fault == "gate_swapped":
        monkeypatch.setattr(tuni, "_swiglu", _gate_swapped)
    elif fault == "registers_in_mean":
        monkeypatch.setattr(tuni, "_pool", _registers_in_mean)
    elif fault == "final_ln_cls_only":
        monkeypatch.setattr(tuni, "_residual", _final_ln_on_cls_only())
    else:
        cfg = dataclasses.replace(cfg, resize="bilinear")
    assert _gap(_program(u8, cfg=cfg), _reference(_params(), u8)) > BF16_TOL


def test_bicubic_256_to_224_is_pillow_bit_for_bit():
    """Virchow2's preprocessing filter, 256 -> 224 on the uint8 patch, equals
    Pillow's BICUBIC (the reference's resize) in every byte."""
    u8 = _u8(3, size=256, seed=5)
    got = pil_resize.resize_u8(torch.as_tensor(u8), 224, 224, tuni.Virchow2Config().resize)
    np.testing.assert_array_equal(got.numpy(), ref.resize(u8, 224))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _timm_sd(cfg, params) -> dict:
    """A timm ``vit_huge_patch14_224`` state dict of ``params`` (the inverse
    of the loader's layout), as float64 tensors."""
    p, d = cfg.patch_size, cfg.dim
    sd = {"patch_embed.proj.weight": params["patch_w"].reshape(p, p, 3, d).permute(3, 2, 0, 1),
          "patch_embed.proj.bias": params["patch_b"],
          "cls_token": params["cls_token"].reshape(1, 1, d),
          "reg_token": params["reg_token"].reshape(1, cfg.reg_tokens, d),
          "pos_embed": params["pos_emb"].reshape(1, cfg.tokens, d),
          "norm.weight": params["norm_scale"], "norm.bias": params["norm_bias"]}
    names = {"ln1_scale": "norm1.weight", "ln1_bias": "norm1.bias",
             "w_qkv": "attn.qkv.weight", "b_qkv": "attn.qkv.bias",
             "w_proj": "attn.proj.weight", "b_proj": "attn.proj.bias", "ls1": "ls1.gamma",
             "ln2_scale": "norm2.weight", "ln2_bias": "norm2.bias",
             "w_fc1": "mlp.fc1.weight", "b_fc1": "mlp.fc1.bias",
             "w_fc2": "mlp.fc2.weight", "b_fc2": "mlp.fc2.bias", "ls2": "ls2.gamma"}
    for key, name in names.items():
        for i in range(cfg.depth):
            t = params["blocks"][key][i]
            sd[f"blocks.{i}.{name}"] = t.T if key.startswith("w_") else t
    return {k: v.contiguous().double() for k, v in sd.items()}


def test_virchow2_from_torch_round_trip():
    """A timm-layout state dict fabricated from the seeded tree loads back to
    the same tree and config (packed fc1 (854, 160), fc2 (160, 427),
    reg_token (1, 4, 160)); the head count is inferred only at 1280."""
    cfg = _cfg()
    params = _params(3)
    sd = _timm_sd(cfg, params)
    assert sd["blocks.0.mlp.fc1.weight"].shape == (854, 160)
    assert sd["blocks.0.mlp.fc2.weight"].shape == (160, 427)
    with pytest.raises(ValueError, match="head count"):
        tuni.virchow2_from_torch(sd)
    got_cfg, got = tuni.virchow2_from_torch(sd, heads=2)
    assert isinstance(got_cfg, tuni.Virchow2Config) and got_cfg == cfg
    assert set(got) == set(params) and set(got["blocks"]) == set(params["blocks"])
    for k, v in params.items():
        if k != "blocks":
            assert torch.equal(got[k], v), k
    for k, v in params["blocks"].items():
        assert torch.equal(got["blocks"][k], v), k


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------

def test_slide_program_virchow2_matches_extractor_and_folds(monkeypatch):
    """``make_slide_program(backbone="virchow2")`` (the default config swapped
    for the tiny one) gives the ViS over the cluster means of the features
    ``FeatureExtractor("virchow2")`` gives, with the clustering fixed."""
    vcfg = tvis.ViSConfig(num_outputs=4, input_dim=320, depth=1, nheads=2, dim_f=4, dim_s=4,
                          dim_c=4, num_clusters=3)
    vp = tvis.init(vcfg, torch.Generator().manual_seed(1))
    params = _params()
    tiny = _cfg()
    monkeypatch.setattr(tuni, "Virchow2Config", lambda compute_dtype: tiny)
    u8 = _u8(8, seed=6).reshape(2, 4, 40, 40, 3)
    labels = torch.arange(8) % 3

    def fixed(feats, mask, gen, n_clusters, use_pallas=False):
        return None, labels, None, 1
    monkeypatch.setattr(tfused.km, "kmeans_fit", fixed)
    run = tfused.make_slide_program(params, vcfg, vp, n_clusters=3,
                                    compute_dtype=torch.float32, backbone="virchow2",
                                    device="cpu")
    got = run(u8, torch.Generator().manual_seed(2))
    monkeypatch.undo()
    feats = FeatureExtractor("virchow2", params, batch_size=4, cfg=tiny, device="cpu",
                             patch_size=40).features(u8.reshape(8, 40, 40, 3))
    cf = torch.stack([feats[labels == c].mean(0) for c in range(3)])
    want = tvis.apply(vcfg, vp, cf[None])[0]
    assert got.shape == (4,)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def v2_files(tmp_path_factory):
    """A Virchow2 state dict at the published width (1280: 16 heads are
    inferred) and depth 1, 28-px input, a packed fc1 of 64; two ViS folds
    at input 2560."""
    root = tmp_path_factory.mktemp("v2_cli")
    cfg = tuni.Virchow2Config(img_size=28, depth=1, mlp_dim=64)
    sd = _timm_sd(cfg, tuni.random_params(cfg, torch.Generator().manual_seed(4),
                                          layer_scale=0.1))
    checkpoint.save_torch_state_dict({k: v.float().numpy() for k, v in sd.items()},
                                     str(root / "v2.pt"))
    vcfg = tvis.ViSConfig(num_outputs=3, input_dim=2560, depth=1, nheads=2, dim_f=4, dim_s=4,
                          dim_c=4, num_clusters=4)
    return root, cfg, [(vcfg, tvis.init(vcfg, torch.Generator().manual_seed(10 + i)))
                       for i in range(2)]


def test_load_extractor_and_build_predictor_serve_virchow2(v2_files, monkeypatch):
    """``load_extractor("virchow2", path)`` takes its config from the state
    dict, and ``cli/serve.build_predictor`` serves patches through it:
    ``predict_patches`` gives the folds' mean over the cluster means of the
    reference's features (the clustering fixed to the first rows)."""
    root, cfg, folds = v2_files
    path = str(root / "v2.pt")
    ext = load_extractor("virchow2", path, 4, "float32", device="cpu")
    assert ext.cfg == cfg and ext.feature_dim == 2560 and ext.feat_type == "virchow2"
    bf = load_extractor("virchow2", path, 4, "bfloat16", device="cpu")
    assert bf.params["blocks"]["w_fc1"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="fused_stages"):
        load_extractor("virchow2", path, 4, device="cpu", fused_stages=(1,))

    monkeypatch.setattr(SlidePredictor, "cluster", lambda self, f: f[:4].float())
    pred, line = tcli.build_predictor("virchow2", path, folds, device="cpu", batch_size=4,
                                      compute_dtype="float32", n_clusters=4)
    assert pred.extractor.feat_type == "virchow2" and "none (plain PyTorch)" in line
    u8 = _u8(6, size=48, seed=7)
    got = pred.predict_patches(u8)
    _, params = tuni.virchow2_from_torch(checkpoint.load_torch_checkpoint(path))
    feats = ref.features(params, u8[:4], img=28, patch=14, heads=16, device="cpu")
    want = torch.stack([tvis.apply(c, p, feats[None])[0] for c, p in folds]).mean(0)
    np.testing.assert_allclose(np.asarray(got)[0], want.numpy(), rtol=1e-4, atol=1e-5)


def test_serving_kernels_leave_k1_out_of_2560_d_folds(v2_files, monkeypatch):
    """On a card the serve CLI names K1 as left out for Virchow2's 2560-d
    folds, with ``cuda_vis.kernel_takes``' reason."""
    _, _, folds = v2_files
    monkeypatch.setattr(tcli, "resolve_device", lambda d: torch.device("cuda"))
    on, why = tcli.serving_kernels("cuda", folds)
    assert "vis_blocks_fused" not in on and "lloyd_stats" in on
    assert "input_dim / 2" in why


def test_cli_serves_virchow2(v2_files, monkeypatch, tmp_path):
    """``python -m sequoia_tpu_torch.cli.serve --feat_type virchow2`` serves a
    slide into a finite CSV, and refuses 1024-d folds against its 2560-d
    features."""
    from PIL import Image

    from tests.test_pipeline_e2e import synthetic_wsi

    root, _, folds = v2_files
    exp = tmp_path / "exp"
    exp.mkdir()
    genes = ["G0", "G1", "G2"]
    monkeypatch.setattr(tcli, "load_fold_models", lambda path, model_type="vis": folds)
    with open(exp / "test_results.pkl", "wb") as f:
        pickle.dump({"genes": genes}, f)
    Image.fromarray(synthetic_wsi(w=512, h=384, seed=3).levels[0]).save(tmp_path / "slide.png")
    monkeypatch.chdir(tmp_path)
    out = tcli.main(["--wsi", "slide.png", "--checkpoints", str(exp), "--feat_type",
                     "virchow2", "--weights", str(root / "v2.pt"), "--batch_size", "4",
                     "--compute_dtype", "float32", "--max_patches", "12", "--patch_size",
                     "64", "--num_clusters", "4", "--device", "cpu", "--out", "port.csv"])
    assert out["slides"] == 1 and out["failed"] == 0
    with open("port.csv") as f:
        rows = [r.strip().split(",") for r in f]
    assert rows[0] == ["wsi_file_name", *genes] and rows[1][0] == "slide.png"
    assert np.isfinite(np.asarray(rows[1][1:], float)).all()
    narrow = [(dataclasses.replace(c, input_dim=1024), p) for c, p in folds]
    monkeypatch.setattr(tcli, "load_fold_models", lambda path, model_type="vis": narrow)
    with pytest.raises(SystemExit, match="2560-d features but the checkpoint expects "
                                         "input_dim 1024"):
        tcli.main(["--wsi", "slide.png", "--checkpoints", str(exp), "--feat_type", "virchow2",
                   "--weights", str(root / "v2.pt"), "--num_clusters", "4", "--device", "cpu"])


# ---------------------------------------------------------------------------
# UNI unchanged
# ---------------------------------------------------------------------------

#: sha256 of UNI's f32 and bf16 forward and ``extract_from_uint8`` at
#: :func:`_uni_digest`'s size, taken before Virchow2 joined the module
UNI_DIGESTS = {
    "float32": "9eed77e584e81e763c23c2e3fd6beddd338fa5abea2a5df9ffba03a197c56e54",
    "bfloat16": "3177aa0b37f28a0b8dc346c7f580dd11dbf39f9acbc8eb3ef4ebf50611790cd6",
}


def _uni_digest(dt) -> str:
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = tuni.UniViTConfig(img_size=32, patch_size=8, dim=64, depth=2, heads=2,
                                mlp_dim=128, compute_dtype=dt)
        params = tuni.prepare(cfg, tuni.random_params(cfg, torch.Generator().manual_seed(5),
                                                      layer_scale=0.1))
        x = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(6))
        u8 = torch.as_tensor(np.random.default_rng(7).integers(0, 256, (3, 40, 40, 3),
                                                               dtype=np.uint8))
        with torch.no_grad():
            f = tuni.forward(cfg, params, x)
            e = tuni.extract_from_uint8(cfg, params, u8)
        return hashlib.sha256(f.numpy().tobytes() + e.numpy().tobytes()).hexdigest()
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_uni_forward_is_bitwise_unchanged(dt):
    assert _uni_digest(getattr(torch, dt)) == UNI_DIGESTS[dt]


# ---------------------------------------------------------------------------
# spans and their readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feat_type", ["uni", "virchow2"])
def test_spans_once_per_block_and_batch(feat_type):
    """Under a profiler a forward records ``vit.mlp`` once a block and batch
    and ``vit.preprocess`` once a batch; with no profiler, nothing."""
    from torch.profiler import ProfilerActivity, profile

    if feat_type == "uni":
        cfg = tuni.UniViTConfig(img_size=32, patch_size=16, dim=32, depth=3, heads=2,
                                mlp_dim=64)
    else:
        cfg = _cfg(depth=3)
    params = tuni.random_params(cfg, torch.Generator().manual_seed(0))
    ext = FeatureExtractor(feat_type, params, batch_size=2, cfg=cfg, device="cpu",
                           patch_size=40)
    u8 = _u8(5, seed=8)
    profiling.clear()
    ext.features(u8)
    assert profiling.summary()["spans"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.clear()
        ext.features(u8)
        spans = profiling.summary()["spans"]
    profiling.clear()
    assert spans["vit.mlp"]["count"] == 3 * 3  # 3 batches of 2, the tail padded
    assert spans["vit.preprocess"]["count"] == 3
    assert spans["serve.backbone"]["count"] == 3


def _canned():
    def s(count, device):
        return {"count": count, "host_ms": device, "self_host_ms": device, "device_ms": device}
    return {"spans": {"vit.mlp": s(96, 300.0), "vit.preprocess": s(3, 12.0),
                      "vit.attn": s(96, 90.0)}, "counters": {}}


@pytest.mark.parametrize("name, value", [("vit_mlp_ms_per_kpatch", 150.0),
                                         ("vit_preprocess_ms_per_kpatch", 6.0),
                                         ("vit_attn_ms_per_kpatch", 45.0)])
def test_span_readers_known_value(monkeypatch, name, value):
    """Per thousand of the traced slides' patches: 300 ms of ``vit.mlp``,
    12 ms of ``vit.preprocess`` and 90 ms of ``vit.attn`` over 2,000 traced
    patches; nothing from an untraced run, a program without the recorder or
    without the spans."""
    reader = bench_run.reader(common.ROOT, name)
    rec = {"trace": {"window_s": 1.0}, "items": {"patches": 40000, "patches_traced": 2000}}
    monkeypatch.setattr(profiling, "summary", _canned)
    assert reader.read(rec) == pytest.approx(value)
    assert reader.read(dict(rec, trace=None)) is None
    monkeypatch.setattr(profiling, "summary", lambda: {"spans": {}, "counters": {}})
    assert reader.read(rec) is None
    monkeypatch.delattr(profiling, "summary")
    assert reader.read(rec) is None
