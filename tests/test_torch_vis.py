"""Port ViS (models/vis.py, models/convert.py, ops/cuda_vis.py) against the
JAX package on the CPU: the plain forward, the weight converters, the packed
layout, and the fused block stack's plain version against the Pallas kernel
run in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.models import convert as jconvert
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.ops import pallas_vis as jpv
from sequoia_tpu_torch.models import convert as tconvert
from sequoia_tpu_torch.models import vis as tvis
from sequoia_tpu_torch.ops import cuda_vis as tpv


def _cfgs(depth=2, compute_dtype=None, **kw):
    """The (JAX, port) config pair of tests/test_pallas_vis.py."""
    base = dict(num_outputs=32, input_dim=256, depth=depth, nheads=4, dim_f=32,
                dim_s=32, dim_c=32, num_clusters=10, compute_dtype=compute_dtype)
    base.update(kw)
    return jvis.ViSConfig(**base), tvis.ViSConfig(**base)


def _carry(jparams):
    return tconvert.vis_params_from_numpy(jax.tree.map(np.asarray, jparams))


def _x(n, d, seed):
    return np.random.default_rng(seed).normal(size=(1, n, d)).astype(np.float32)


@pytest.mark.parametrize("depth,n", [(1, 10), (2, 100)])
def test_apply_matches_jax_f32(depth, n):
    jcfg, tcfg = _cfgs(depth=depth, num_clusters=n)
    jp = jvis.init(jcfg, jax.random.PRNGKey(depth))
    x = np.concatenate([_x(n, 256, 0), _x(n, 256, 1)])  # B = 2
    want = np.asarray(jvis.apply(jcfg, jp, jnp.asarray(x)))
    got = tvis.apply(tcfg, _carry(jp), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_apply_matches_jax_f32_production_shape():
    """D=2048, depth 6, 16 heads, 20,820 genes, 100 tokens.  Weights made by
    the port's init (torch.Generator), carried to JAX as numpy."""
    tcfg = tvis.ViSConfig(num_outputs=20820, input_dim=2048, num_clusters=100)
    jcfg = jvis.ViSConfig(num_outputs=20820, input_dim=2048, num_clusters=100)
    tp = tvis.init(tcfg, torch.Generator().manual_seed(0))
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    x = _x(100, 2048, 2)
    want = np.asarray(jvis.apply(jcfg, jp, jnp.asarray(x)))
    got = tvis.apply(tcfg, tp, torch.as_tensor(x)).numpy()
    assert got.shape == (1, 20820)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_apply_bf16_close_to_jax_bf16():
    jcfg, tcfg = _cfgs(depth=2, compute_dtype="bfloat16")
    jp = jvis.init(jcfg, jax.random.PRNGKey(0))
    x = _x(10, 256, 3)
    want = np.asarray(jvis.apply(jcfg, jp, jnp.asarray(x)))
    got = tvis.apply(tcfg, _carry(jp), torch.as_tensor(x)).numpy()
    f32 = np.asarray(jvis.apply(_cfgs(depth=2)[0], jp, jnp.asarray(x)))
    # both round through bf16 (JAX on the CPU also accumulates dots in bf16)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
    assert np.abs(got - f32).max() < 10 * np.abs(want - f32).max() + 1e-3


def test_torch_state_dict_round_trip_matches_jax_converter():
    jcfg, tcfg = _cfgs(depth=2)
    jp = jvis.init(jcfg, jax.random.PRNGKey(7))
    tp = _carry(jp)
    sd_t = tconvert.vis_to_torch(tcfg, tp)
    sd_j = jconvert.vis_to_torch(jcfg, jp)
    assert list(sd_t) == list(sd_j)
    for k in sd_j:
        np.testing.assert_array_equal(sd_t[k], np.asarray(sd_j[k]), err_msg=k)
    cfg2, tp2 = tconvert.vis_from_torch(sd_t)
    assert cfg2 == tcfg
    for k, v in tp2["blocks"].items():
        torch.testing.assert_close(v, tp["blocks"][k], rtol=0, atol=0)
    for k in ("pos_emb", "head_w", "head_b", "head_ln_scale", "head_ln_bias"):
        torch.testing.assert_close(tp2[k], tp[k], rtol=0, atol=0)


def test_slice_head_matches_full_output():
    jcfg, tcfg = _cfgs(depth=1)
    tp = _carry(jvis.init(jcfg, jax.random.PRNGKey(1)))
    idx = [5, 0, 31]
    cfg2, tp2 = tvis.slice_head(tcfg, tp, idx)
    x = torch.as_tensor(_x(10, 256, 4))
    assert cfg2.num_outputs == 3
    torch.testing.assert_close(tvis.apply(cfg2, tp2, x), tvis.apply(tcfg, tp, x)[:, idx])


def test_supported_predicate_matches_jax():
    for kw in ({}, {"input_dim": 384}, {"dim_s": 16}):
        jcfg, tcfg = _cfgs(**kw)
        assert tpv.supported(tcfg) == jpv.supported(jcfg)
    small = dict(num_outputs=8, input_dim=64, nheads=2, dim_f=16, dim_s=16, dim_c=16,
                 num_clusters=4)
    assert not tpv.supported(tvis.ViSConfig(**small))


def test_pack_vis_blocks_matches_jax():
    jcfg, tcfg = _cfgs(depth=2)
    jp = jvis.init(jcfg, jax.random.PRNGKey(3))
    want = jpv.pack_vis_blocks(jcfg, jp, dtype=jnp.float32)
    got = tpv.pack_vis_blocks(tcfg, _carry(jp), dtype=torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("depth,n", [(1, 10), (3, 10), (2, 100)])
def test_fused_plain_matches_jax_interpret_f32(depth, n):
    jcfg, tcfg = _cfgs(depth=depth, num_clusters=n)
    jp = jvis.init(jcfg, jax.random.PRNGKey(depth))
    x = _x(n, 256, n)
    want = np.asarray(jpv.vis_apply_fused(
        jcfg, jp, jpv.pack_vis_blocks(jcfg, jp, dtype=jnp.float32), jnp.asarray(x),
        interpret=True))
    tp = _carry(jp)
    got = tpv.vis_apply_fused(tcfg, tp, tpv.pack_vis_blocks(tcfg, tp, torch.float32),
                              torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # and the fused stack is the plain forward, block for block
    np.testing.assert_allclose(got, tvis.apply(tcfg, tp, torch.as_tensor(x)).numpy(),
                               rtol=2e-4, atol=2e-5)


def test_fused_bf16_close_to_bf16_apply():
    """tests/test_pallas_vis.py:48-61 with the port's fused stack."""
    jcfg, tcfg = _cfgs(depth=2, compute_dtype="bfloat16")
    jp = jvis.init(jcfg, jax.random.PRNGKey(0))
    tp = _carry(jp)
    x = _x(jcfg.num_clusters, 256, 1)
    want = np.asarray(jvis.apply(jcfg, jp, jnp.asarray(x)))
    got = tpv.vis_apply_fused(tcfg, tp, tpv.pack_vis_blocks(tcfg, tp, torch.bfloat16),
                              torch.as_tensor(x)).numpy()
    f32 = np.asarray(jvis.apply(_cfgs(depth=2)[0], jp, jnp.asarray(x)))
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
    assert np.abs(got - f32).max() < 10 * np.abs(want - f32).max() + 1e-3


def test_fused_bf16_plain_matches_jax_interpret_bf16():
    jcfg, tcfg = _cfgs(depth=2, compute_dtype="bfloat16")
    jp = jvis.init(jcfg, jax.random.PRNGKey(5))
    tp = _carry(jp)
    x = _x(jcfg.num_clusters, 256, 6)
    want = np.asarray(jpv.vis_apply_fused(
        jcfg, jp, jpv.pack_vis_blocks(jcfg, jp, dtype=jnp.bfloat16), jnp.asarray(x),
        interpret=True))
    got = tpv.vis_apply_fused(tcfg, tp, tpv.pack_vis_blocks(tcfg, tp, torch.bfloat16),
                              torch.as_tensor(x)).numpy()
    # same rounding points; a bf16 value on a rounding boundary may land one
    # ulp apart (JAX-on-CPU accumulates bf16 dots differently)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


def test_fused_rejects_batch():
    _, tcfg = _cfgs()
    tp = tvis.init(tcfg, torch.Generator().manual_seed(0))
    packed = tpv.pack_vis_blocks(tcfg, tp, torch.float32)
    x = torch.zeros((2, tcfg.num_clusters, tcfg.input_dim))
    with pytest.raises(ValueError, match="B=1"):
        tpv.vis_apply_fused(tcfg, tp, packed, x)


def test_init_shapes_match_jax():
    jcfg, tcfg = _cfgs(depth=2)
    jp = jvis.init(jcfg, jax.random.PRNGKey(0))
    tp = tvis.init(tcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tp["blocks"].items()} == \
        {k: tuple(v.shape) for k, v in jp["blocks"].items()}
    for k in ("pos_emb", "head_w", "head_b"):
        assert tuple(tp[k].shape) == tuple(jp[k].shape)
    bound = 1 / np.sqrt(tcfg.input_dim)
    assert float(tp["blocks"]["wf"].abs().max()) <= bound
