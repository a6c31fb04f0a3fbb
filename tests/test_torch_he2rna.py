"""Port models/he2rna.py and the HE2RNA converters against the JAX package
on the CPU: the eval forward with zero-padded tiles at T = 100 (1e-4
relative, as tests/test_models_parity.py holds JAX against the torch
golden), the train forward with one k, the custom top-k backward against
autograd through ``torch.topk`` and the parameter gradients against JAX
(rtol 1e-5, atol 1e-6), padded rows, the converters, ``slice_head`` and
``replace_head``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.models import convert as jconvert
from sequoia_tpu.models import he2rna as jhe
from sequoia_tpu.ops import stats as jstats
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.models import he2rna
from sequoia_tpu_torch.ops import stats
from tests import torch_goldens as tg


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _pair(cfg_kw, seed=0):
    """A JAX init and its port copy."""
    jcfg = jhe.HE2RNAConfig(**cfg_kw)
    jp = jhe.init(jcfg, jax.random.PRNGKey(seed))
    tp = convert.he2rna_params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, jp, he2rna.HE2RNAConfig(**cfg_kw), tp


def test_eval_parity_with_padding_at_100_tiles():
    D, layers, G, B, T = 24, (16, 16), 9, 3, 100
    ks = (1, 2, 5, 10, 20, 50, 100)
    rng = torch.Generator().manual_seed(6)
    sd = tg.make_torch_sd(rng, tg.he2rna_shapes(D, layers, G))
    x = torch.rand(B, T, D, generator=rng).double()
    x[0, 80:] = 0.0
    x[1, 15:] = 0.0
    golden = tg.he2rna_eval_forward(sd, x, n_layers=3, ks=ks).numpy()

    cfg, params = convert.he2rna_from_torch(sd)
    assert cfg == he2rna.HE2RNAConfig(input_dim=D, output_dim=G, layers=layers, ks=ks)
    got = he2rna.apply(cfg, params, x.float())
    assert got.dtype == torch.float32 and got.shape == (B, G)
    assert rel_err(got, golden) < 1e-4
    jcfg, jparams = jconvert.he2rna_from_torch(sd)
    want = jhe.apply(jcfg, jparams, jnp.asarray(x.numpy(), jnp.float32))
    assert rel_err(got, want) < 1e-4


def test_train_forward_uses_a_single_k():
    jcfg, jp, cfg, params = _pair(dict(input_dim=8, output_dim=4, layers=(6,), ks=(1, 3),
                                       dropout=0.0))
    x = np.abs(np.random.default_rng(1).normal(size=(2, 5, 8))).astype(np.float32)
    xt = torch.from_numpy(x)
    k_gen = torch.Generator().manual_seed(0)
    outs = {float(he2rna.apply(cfg, params, xt, train=True, k_gen=k_gen)[0, 0])
            for _ in range(12)}
    scores = jhe.tile_scores(jcfg, jp, jnp.asarray(x))
    mask = (jnp.max(jnp.asarray(x), axis=2) > 0).astype(jnp.float32)
    fixed = [float(jhe._topk_masked_mean(scores, mask, k)[0, 0]) for k in jcfg.ks]
    assert len(outs) == 2
    for o in outs:
        assert min(abs(o - f) for f in fixed) < 1e-6
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        he2rna.apply(cfg, params, xt, train=True)


def test_dropout_draws_from_the_generator():
    cfg = he2rna.HE2RNAConfig(input_dim=8, output_dim=4, layers=(32,), ks=(2,))
    params = he2rna.init(cfg, torch.Generator().manual_seed(0))
    x = torch.rand(3, 6, 8, generator=torch.Generator().manual_seed(1))

    def run(seed):
        return he2rna.apply(cfg, params, x, train=True, gen=torch.Generator().manual_seed(seed),
                            k_gen=torch.Generator().manual_seed(0))

    assert torch.equal(run(4), run(4)) and not torch.equal(run(4), run(5))
    with pytest.raises(ValueError, match="generator"):
        he2rna.apply(cfg, params, x, train=True, k_gen=torch.Generator())


def test_topk_backward_matches_autograd_and_jax():
    """The hand-written backward equals autograd through torch.topk and the
    JAX custom VJP (tie-free scores: every row's top k is unique)."""
    rng = np.random.default_rng(9)
    B, T, G, k = 3, 20, 7, 5
    s = rng.normal(size=(B, T, G)).astype(np.float32)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    st = torch.tensor(s, requires_grad=True)
    mt = torch.from_numpy(mask)
    (he2rna.topk_masked_mean(st, mt, k) ** 2).sum().backward()

    sa = torch.tensor(s, requires_grad=True)
    top = torch.topk((sa * mt[:, :, None]).transpose(1, 2), k, dim=2).values
    ref = (top * mt[:, None, :k]).sum(2) / mt[:, :k].sum(1)[:, None]
    (ref ** 2).sum().backward()
    np.testing.assert_allclose(st.grad.numpy(), sa.grad.numpy(), rtol=1e-5, atol=1e-6)

    jg = jax.grad(lambda v: jnp.sum(jhe._topk_masked_mean(v, jnp.asarray(mask), k) ** 2))(
        jnp.asarray(s))
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_parameter_gradients_match_jax():
    """Train-mode loss gradients (dropout 0, one k) with respect to every
    parameter, on positive tiles with padded tails: masked tiles score 0 and
    may be picked at different tied positions, where the mask zeroes the
    gradient."""
    jcfg, jp, cfg, params = _pair(dict(input_dim=16, output_dim=6, layers=(12, 10), ks=(4,),
                                       dropout=0.0), seed=3)
    rng = np.random.default_rng(4)
    x = np.abs(rng.normal(size=(4, 9, 16))).astype(np.float32)
    x[1, 6:] = 0.0
    x[3] = 0.0  # a padded batch row
    y = rng.normal(size=(4, 6)).astype(np.float32)
    valid = np.array([True, True, True, False])

    def jloss(p):
        pred = jhe.apply(jcfg, p, jnp.asarray(x), train=True, rng=jax.random.PRNGKey(0))
        return jstats.masked_mse(pred, jnp.asarray(y), jnp.asarray(valid))

    jl, jgrad = jax.value_and_grad(jloss)(jp)
    leaves = [t.clone().requires_grad_(True) for t in params["w"] + params["b"]]
    tp = {"w": leaves[:3], "b": leaves[3:]}
    pred = he2rna.apply(cfg, tp, torch.from_numpy(x), train=True,
                        k_gen=torch.Generator().manual_seed(0))
    loss = stats.masked_mse(pred, torch.from_numpy(y), torch.from_numpy(valid))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for got, want in zip(leaves, jgrad["w"] + jgrad["b"]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_padded_rows_predict_zero_with_finite_gradients():
    cfg = he2rna.HE2RNAConfig(input_dim=8, output_dim=3, layers=(6,), ks=(1, 3))
    params = he2rna.init(cfg, torch.Generator().manual_seed(0))
    x = torch.rand(4, 5, 8, generator=torch.Generator().manual_seed(1))
    x[3] = 0.0
    valid = torch.tensor([True, True, True, False])
    y = torch.randn(4, 3, generator=torch.Generator().manual_seed(2))
    pred = he2rna.apply(cfg, params, x)
    assert torch.isfinite(pred).all() and torch.equal(pred[3], torch.zeros(3))
    leaves = [t.clone().requires_grad_(True) for t in params["w"] + params["b"]]
    tp = {"w": leaves[:2], "b": leaves[2:]}
    pr = he2rna.apply(cfg, tp, x, train=True, gen=torch.Generator().manual_seed(3),
                      k_gen=torch.Generator().manual_seed(3))
    assert torch.equal(pr[3], torch.zeros(3))
    loss = stats.masked_mse(pr, y, valid)
    loss.backward()
    assert torch.isfinite(loss) and all(torch.isfinite(t.grad).all() for t in leaves)
    # the padded row alone: its scores get exactly zero gradient
    s = torch.randn(2, 4, 3, requires_grad=True)
    m = torch.tensor([[1.0, 1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    he2rna.topk_masked_mean(s, m, 2).sum().backward()
    assert torch.equal(s.grad[1], torch.zeros(4, 3)) and torch.isfinite(s.grad).all()


def test_converters_match_jax():
    jcfg, jp, cfg, params = _pair(dict(input_dim=12, output_dim=5, layers=(7, 6)))
    sd = convert.he2rna_to_torch(cfg, params)
    jsd = jconvert.he2rna_to_torch(jcfg, jp)
    assert list(sd) == list(jsd)
    for k in jsd:
        np.testing.assert_array_equal(sd[k], jsd[k])
    cfg2, p2 = convert.he2rna_from_torch(sd)
    assert cfg2 == cfg and dict(vars(cfg2)) == dict(vars(jconvert.he2rna_from_torch(jsd)[0]))
    for a, b in zip(p2["w"] + p2["b"], params["w"] + params["b"]):
        assert torch.equal(a, b)
    sd["__ks__"] = np.array([1, 4])
    assert convert.he2rna_config_from_state_dict(sd).ks == (1, 4)
    assert he2rna.ks_for_tokens(30) == jhe.ks_for_tokens(30) == (1, 2, 5, 10, 20)
    for t in (None, 0, 1, 100):
        assert he2rna.ks_for_tokens(t) == jhe.ks_for_tokens(t)


def test_slice_head_and_replace_head():
    jcfg, jp, cfg, params = _pair(dict(input_dim=24, output_dim=9, layers=(8,), ks=(1, 2)),
                                  seed=1)
    x = np.abs(np.random.default_rng(0).normal(size=(2, 6, 24))).astype(np.float32)
    full = he2rna.apply(cfg, params, torch.from_numpy(x))
    scfg, sp = he2rna.slice_head(cfg, params, [8, 2])
    jscfg, jsp = jhe.slice_head(jcfg, jp, [8, 2])
    assert scfg.output_dim == jscfg.output_dim == 2
    part = he2rna.apply(scfg, sp, torch.from_numpy(x))
    np.testing.assert_allclose(part.numpy(), full.numpy()[:, [8, 2]], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(part.numpy(), np.asarray(jhe.apply(jscfg, jsp, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="out of range"):
        he2rna.slice_head(cfg, params, [9])

    rcfg, rp = he2rna.replace_head(cfg, params, 5, torch.Generator().manual_seed(2))
    jrcfg, jrp = jhe.replace_head(jcfg, jp, 5, jax.random.PRNGKey(2))
    assert rcfg.output_dim == jrcfg.output_dim == 5
    assert rp["w"][-1].shape == tuple(jrp["w"][-1].shape) == (8, 5)
    assert torch.equal(rp["w"][0], params["w"][0]) and rp["w"][0] is params["w"][0]
    bound = 1 / np.sqrt(8)
    assert float(rp["w"][-1].abs().max()) <= bound and float(rp["b"][-1].abs().max()) <= bound


def test_init_shapes_and_bias_init():
    cfg = he2rna.HE2RNAConfig(input_dim=10, output_dim=4, layers=(6, 5))
    jcfg = jhe.HE2RNAConfig(input_dim=10, output_dim=4, layers=(6, 5))
    p = he2rna.init(cfg, torch.Generator().manual_seed(0), bias_init=np.arange(4.0))
    jp = jhe.init(jcfg, jax.random.PRNGKey(0), bias_init=np.arange(4.0))
    assert [tuple(w.shape) for w in p["w"]] == [tuple(w.shape) for w in jp["w"]]
    assert [tuple(b.shape) for b in p["b"]] == [tuple(b.shape) for b in jp["b"]]
    np.testing.assert_array_equal(p["b"][-1].numpy(), np.asarray(jp["b"][-1]))
