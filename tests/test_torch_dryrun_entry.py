"""``sequoia_tpu_torch.dryrun.entry`` against ``__graft_entry__.entry``: the
same config, parameter tree and feature batch at the production widths (JAX's
parameters by ``jax.eval_shape``, so no full-width JAX forward runs), the
port's forward on JAX's parameters at a small width within
``tests/test_torch_vis.py``'s tolerance, and CUDA unless asked."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from sequoia_tpu.models import vis as jvis
from sequoia_tpu_torch import dryrun
from sequoia_tpu_torch.models import convert

SMALL = dict(input_dim=64, num_outputs=32, depth=2, nheads=4, head_dim=8, num_clusters=10)


def shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in shapes(v, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tuple(tree.shape)}


def test_entry_matches_the_jax_entry_at_production_width(monkeypatch):
    seen = {}
    init = jvis.init

    def shape_only(cfg, key):
        seen["cfg"] = cfg
        return jax.eval_shape(lambda k: init(cfg, k), key)

    monkeypatch.setattr(jvis, "init", shape_only)
    jforward, (jparams, jfeats) = graft.entry()
    forward, (params, feats) = dryrun.entry(device="cpu")
    cfg = dryrun.entry_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(seen["cfg"])
    assert (cfg.num_outputs, cfg.input_dim, cfg.depth, cfg.nheads, cfg.num_clusters) == \
        (20820, 2048, 6, 16, 100)
    assert shapes(params) == shapes(jparams)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in dryrun_leaves(params))
    assert feats.dtype == torch.float32 and tuple(feats.shape) == (16, 100, 2048)
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))


def dryrun_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in dryrun_leaves(v)]
    return [tree]


def small(monkeypatch):
    """``entry()`` at a small width, through the helper that names its widths."""
    monkeypatch.setattr(dryrun, "entry_config", functools.partial(dryrun.entry_config, **SMALL))


def test_entry_forward_matches_jax_at_small_width(monkeypatch):
    """The port's forward on JAX's parameters and the entry's features
    against JAX's ``vis.apply`` (rtol 1e-4, atol 1e-5)."""
    small(monkeypatch)
    cfg = dryrun.entry_config()
    jcfg = jvis.ViSConfig(**dataclasses.asdict(cfg))
    jp = jvis.init(jcfg, jax.random.PRNGKey(0))
    forward, (params, feats) = dryrun.entry(device="cpu")
    assert shapes(params) == shapes(jp)
    assert tuple(feats.shape) == (16, 10, 64)
    np.testing.assert_array_equal(
        feats.numpy(), np.random.default_rng(0).normal(size=(16, 10, 64)).astype(np.float32))
    want = np.asarray(jvis.apply(jcfg, jp, jnp.asarray(feats.numpy())))
    got = forward(convert.vis_params_from_numpy(jax.tree.map(np.asarray, jp)), feats)
    assert got.shape == (16, 32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)
    # and on the entry's own weights: finite, deterministic
    again = dryrun.entry(device="cpu")
    out = forward(params, feats)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(again[0](*again[1]), out, rtol=0, atol=0)


def test_entry_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.entry()
    small(monkeypatch)
    _, (params, feats) = dryrun.entry(device="cpu")
    assert feats.device.type == "cpu" and params["head_w"].device.type == "cpu"
