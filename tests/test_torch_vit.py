"""Port models/vit.py and the ViT converters against the JAX package on the
CPU: the forward in f32 (rtol 1e-4, as the ViS forward is held) and bf16, the
state-dict converters, the head surgery and ``posemb_sincos_2d``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.models import convert as jconvert
from sequoia_tpu.models import vit as jvit
from sequoia_tpu_torch.models import convert as tconvert
from sequoia_tpu_torch.models import vit as tvit


def _cfgs(**kw):
    base = dict(num_outputs=24, dim=64, depth=2, heads=4, dim_head=16, mlp_dim=96,
                num_clusters=10, compute_dtype=None)
    base.update(kw)
    return jvit.ViTConfig(**base), tvit.ViTConfig(**base)


def _carry(jparams):
    return tconvert.vit_params_from_numpy(jax.tree.map(np.asarray, jparams))


def _x(b, n, d, seed):
    return np.random.default_rng(seed).normal(size=(b, n, d)).astype(np.float32)


@pytest.mark.parametrize("depth,b", [(1, 1), (2, 3)])
def test_apply_matches_jax_f32(depth, b):
    jcfg, tcfg = _cfgs(depth=depth)
    jp = jvit.init(jcfg, jax.random.PRNGKey(depth))
    x = _x(b, 10, 64, depth)
    want = np.asarray(jvit.apply(jcfg, jp, jnp.asarray(x)))
    got = tvit.apply(tcfg, _carry(jp), torch.as_tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_apply_bf16_close_to_jax_bf16():
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    jp = jvit.init(jcfg, jax.random.PRNGKey(0))
    x = _x(2, 10, 64, 5)
    want = np.asarray(jvit.apply(jcfg, jp, jnp.asarray(x)))
    got = tvit.apply(tcfg, _carry(jp), torch.as_tensor(x))
    assert got.dtype == torch.float32
    got = got.numpy()
    f32 = np.asarray(jvit.apply(_cfgs()[0], jp, jnp.asarray(x)))
    # both round through bf16 (JAX on the CPU also accumulates dots in bf16)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
    assert np.abs(got - f32).max() < 10 * np.abs(want - f32).max() + 1e-3


def test_init_shapes_match_jax():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jvit.init(jcfg, jax.random.PRNGKey(0)))
    tp = tvit.init(tcfg, torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == sum(len(v) if isinstance(v, dict) else 1 for v in tp.values())
    for path, leaf in flat_j:
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32


def test_state_dict_converters_match_jax():
    jcfg, tcfg = _cfgs()
    jp = jvit.init(jcfg, jax.random.PRNGKey(7))
    sd_j = jconvert.vit_to_torch(jcfg, jp)
    sd_t = tconvert.vit_to_torch(tcfg, _carry(jp))
    assert list(sd_t) == list(sd_j)
    for k in sd_j:
        np.testing.assert_array_equal(sd_t[k], np.asarray(sd_j[k]))
    assert dataclass_fields(tconvert.vit_config_from_state_dict(sd_j)) == dataclass_fields(
        jconvert.vit_config_from_state_dict(sd_j))
    cfg_t, p_t = tconvert.vit_from_torch(sd_j)
    cfg_j, p_j = jconvert.vit_from_torch(sd_j)
    assert dataclass_fields(cfg_t) == dataclass_fields(cfg_j)
    for path, leaf in jax.tree_util.tree_leaves_with_path(p_j):
        node = p_t
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def dataclass_fields(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


def test_slice_and_replace_head():
    jcfg, tcfg = _cfgs()
    jp = jvit.init(jcfg, jax.random.PRNGKey(1))
    tp = _carry(jp)
    x = _x(2, 10, 64, 2)
    idx = [3, 0, 17]
    jc, js = jvit.slice_head(jcfg, jp, idx)
    tc, ts = tvit.slice_head(tcfg, tp, idx)
    assert tc.num_outputs == jc.num_outputs == 3
    np.testing.assert_allclose(tvit.apply(tc, ts, torch.as_tensor(x)).numpy(),
                               np.asarray(jvit.apply(jc, js, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        tvit.slice_head(tcfg, tp, [24])
    rc, rp = tvit.replace_head(tcfg, tp, 7, torch.Generator().manual_seed(0))
    assert rc.num_outputs == 7 and tuple(rp["head_w"].shape) == (64, 7)
    assert torch.equal(rp["head_ln_scale"], torch.ones(64))
    assert rp["blocks"] is tp["blocks"]
    assert tuple(tvit.apply(rc, rp, torch.as_tensor(x)).shape) == (2, 7)


@pytest.mark.parametrize("h,w,dim", [(4, 5, 16), (10, 10, 64)])
def test_posemb_sincos_2d_matches_jax(h, w, dim):
    want = np.asarray(jvit.posemb_sincos_2d(h, w, dim))
    got = tvit.posemb_sincos_2d(h, w, dim)
    assert tuple(got.shape) == (h * w, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
