"""The port's UNI backbone (``sequoia_tpu_torch/models/uni_vit.py``) and
everything that serves with it, against the JAX package on the CPU: the f32
forward, the state-dict loader, the bf16 forward, the uint8 preprocessing,
``FeatureExtractor("uni")`` and ``make_slide_program(backbone="uni")``
(serving: tests/test_torch_uni_serve.py).  Inputs come from numpy seeds
and weights from ``tests/torch_goldens.uni_sd`` or the JAX
``random_params``; no ViT-L runs here."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.models import uni_vit as juni
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.pipeline import fused as jfused
from sequoia_tpu.pipeline.features import FeatureExtractor as JExtractor
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.models import uni_vit as tuni
from sequoia_tpu_torch.models import vis as tvis
from sequoia_tpu_torch.pipeline import fused as tfused
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from tests import torch_goldens as tg

# tests/test_backbones.py:52's size
IMG, PATCH, DIM, DEPTH, HEADS, MLP = 32, 8, 64, 2, 4, 128
# the extractor tests' size (tests/test_pil_resize.py:64): 256-px patches resized to 224
EXT = dict(img_size=224, patch_size=56, dim=32, depth=2, heads=4, mlp_dim=64)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-8))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.numpy().transpose(0, 2, 3, 1).astype(np.float32)


def _jax_tree(seed: int, **cfg):
    jcfg = juni.UniViTConfig(**cfg)
    jp = jax.tree.map(np.asarray, juni.random_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jp, tuni.UniViTConfig(**cfg), convert.uni_params_from_numpy(jp)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_f32_matches_jax_and_golden():
    rng = torch.Generator().manual_seed(1)
    sd = tg.uni_sd(rng, IMG, PATCH, DIM, DEPTH, HEADS, MLP)
    x = torch.randn(2, 3, IMG, IMG, generator=rng).double()
    golden = tg.uni_forward(sd, x, depth=DEPTH, heads=HEADS).numpy()
    shape = dict(img_size=IMG, patch_size=PATCH, dim=DIM, depth=DEPTH, heads=HEADS, mlp_dim=MLP)
    cfg, params = tuni.uni_from_torch(sd, tuni.UniViTConfig(**shape))
    jcfg = juni.UniViTConfig(**shape)
    _, jparams = juni.uni_from_torch(sd, jcfg)
    got = tuni.forward(cfg, params, torch.as_tensor(_nhwc(x)))
    want = np.asarray(juni.forward(jcfg, jparams, jnp.asarray(_nhwc(x))))
    assert got.shape == (2, DIM) and got.dtype == torch.float32
    assert rel_err(got, want) < 2e-4  # tests/test_backbones.py:66
    assert rel_err(got, golden) < 2e-4


def test_uni_from_torch_config_and_head_count():
    sd = tg.uni_sd(torch.Generator().manual_seed(2), img=32, patch=8, dim=64, depth=3,
                   heads=4, mlp=96)
    cfg, params = tuni.uni_from_torch(sd, heads=4)
    assert (cfg.depth, cfg.mlp_dim, cfg.img_size, cfg.patch_size, cfg.heads) == (3, 96, 32, 8, 4)
    assert params["blocks"]["w_qkv"].shape == (3, 64, 192)
    _, jparams = juni.uni_from_torch(sd, heads=4)
    for key in ("patch_w", "pos_emb", "cls_token"):
        np.testing.assert_array_equal(params[key].numpy(), np.asarray(jparams[key]))
    for key, v in params["blocks"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jparams["blocks"][key]))
    # a fused-qkv state dict does not record its head count: only the ViT-L
    # width (1024) infers 16
    with pytest.raises(ValueError, match="head count"):
        tuni.uni_from_torch(sd)
    wide = tg.uni_sd(torch.Generator().manual_seed(3), img=32, patch=16, dim=1024, depth=1,
                     heads=16, mlp=64)
    assert tuni.uni_from_torch(wide)[0].heads == 16


def test_forward_bf16_with_loaded_params():
    """bf16 from torch-loaded (strongly typed f32) params: finite, within
    3e-2 of max |f32| of the f32 forward (bf16 rounds the activations at
    every GEMM), and of JAX's bf16 forward; the weights are cast once."""
    rng = torch.Generator().manual_seed(4)
    sd = tg.uni_sd(rng, IMG, PATCH, DIM, DEPTH, HEADS, MLP)
    x = _nhwc(torch.randn(3, 3, IMG, IMG, generator=rng))
    cfg, params = tuni.uni_from_torch(sd, heads=HEADS)
    bcfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    prepared = tuni.prepare(bcfg, params)
    assert prepared["blocks"]["w_fc1"].dtype == torch.bfloat16
    assert tuni.prepare(cfg, params) is params
    got = tuni.forward(bcfg, prepared, torch.as_tensor(x))
    f32 = tuni.forward(cfg, params, torch.as_tensor(x))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert rel_err(got, f32) < 3e-2
    jcfg, jparams = juni.uni_from_torch(sd, heads=HEADS)
    jb = juni.forward(dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16), jparams,
                      jnp.asarray(x))
    assert rel_err(got, jb) < 3e-2


def test_extract_from_uint8_matches_jax():
    """The Pillow-exact resize to 224, then ImageNet normalization, then the
    forward: the JAX function's output at the forward's tolerance."""
    jcfg, jp, cfg, params = _jax_tree(0, **EXT)
    u8 = _u8((2, 256, 256, 3), 5)
    got = tuni.extract_from_uint8(cfg, params, torch.as_tensor(u8))
    want = np.asarray(juni.extract_from_uint8(jcfg, jax.tree.map(jnp.asarray, jp),
                                              jnp.asarray(u8)))
    assert got.shape == (2, EXT["dim"]) and rel_err(got, want) < 2e-4


# ---------------------------------------------------------------------------
# the extractor and the slide program
# ---------------------------------------------------------------------------

def test_feature_extractor_uni_matches_jax():
    """``FeatureExtractor("uni")``: 1024-d where the cfg says so (here 32)
    and JAX's extractor's features."""
    jcfg, jp, cfg, params = _jax_tree(0, **EXT)
    u8 = _u8((8, 256, 256, 3), 3)
    ext = FeatureExtractor("uni", params, batch_size=8, cfg=cfg, device="cpu")
    got = ext(u8)
    assert got.shape == (8, EXT["dim"]) and ext.feature_dim == EXT["dim"]
    want = JExtractor("uni", jax.tree.map(jnp.asarray, jp), batch_size=8, cfg=jcfg)(u8)
    assert rel_err(got, want) < 2e-4
    assert ext.cfg is cfg
    with pytest.raises(ValueError, match="conflicts"):
        FeatureExtractor("uni", params, cfg=cfg, compute_dtype="bfloat16", device="cpu")


def _fixed_labels(n_clusters):
    """kmeans_fit stand-in shared by both packages: point i in cluster i % k."""
    def fit(feats, mask, key, n_clusters=n_clusters, **_):
        lab = np.arange(feats.shape[0]) % n_clusters
        return None, (torch.as_tensor(lab) if isinstance(feats, torch.Tensor)
                      else jnp.asarray(lab)), None, None
    return fit


@pytest.mark.parametrize("kernels", [False, True])
def test_slide_program_uni_matches_jax(monkeypatch, kernels):
    """``make_slide_program(backbone="uni")`` with the default config
    swapped for a tiny one in both packages (tests/test_fused.py:61-92) and
    both sides' clustering fixed to the same labels: the same gene vector
    (1e-4, tests/test_fused.py:59).  With ``kernels`` on the CPU the K5
    route runs its plain version and the ViS (input 64 against 2P = 16)
    stays off K1."""
    tiny = dict(img_size=32, patch_size=16, dim=16, depth=2, heads=2, mlp_dim=32)
    jcfg, jp, tcfg, tp = _jax_tree(0, **tiny)
    monkeypatch.setattr(juni, "UniViTConfig", lambda **kw: jcfg)
    monkeypatch.setattr(tuni, "UniViTConfig", lambda **kw: tcfg)
    vis_cfg = dict(num_outputs=4, input_dim=16, depth=1, nheads=2, dim_f=4, dim_s=4, dim_c=4,
                   num_clusters=3)
    jv = jvis.init(jvis.ViSConfig(**vis_cfg), jax.random.PRNGKey(1))
    tv = convert.vis_params_from_numpy(jax.tree.map(np.asarray, jv))
    u8 = _u8((2, 8, 32, 32, 3), 0)
    u8[1, 6:] = 0  # padding rows: masked out of clustering
    jrun = jfused.make_slide_program(jax.tree.map(jnp.asarray, jp), jvis.ViSConfig(**vis_cfg),
                                     jv, n_clusters=3, backbone="uni", compute_dtype=jnp.float32)
    monkeypatch.setattr(jfused.km, "kmeans_fit", _fixed_labels(3))
    want = np.asarray(jrun(jnp.asarray(u8), jax.random.PRNGKey(2)))
    trun = tfused.make_slide_program(tp, tvis.ViSConfig(**vis_cfg), tv, n_clusters=3,
                                     compute_dtype=torch.float32, backbone="uni",
                                     kernels=kernels, device="cpu")
    if not kernels:
        monkeypatch.setattr(tfused.km, "kmeans_fit", _fixed_labels(3))
    got = trun(u8, torch.Generator().manual_seed(2))
    assert got.shape == (4,) and bool(torch.isfinite(got).all())
    if not kernels:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
