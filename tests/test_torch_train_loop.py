"""Port train/loop.py and the train-state checkpoints against the JAX package
on the CPU: three AdamW steps of the ViS and the ViT (params and metrics
within 5e-4 relative), the low-memory AdamW, the early-stop state machine of
``train`` over the same loaders and weights, ``evaluate``/``predict``, the
host-side bf16 upload, and resume."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.data import dataset as jds
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.models import vit as jvit
from sequoia_tpu.train import loop as jloop
from sequoia_tpu_torch.data import dataset as tds
from sequoia_tpu_torch.models import convert as tconvert
from sequoia_tpu_torch.models import vis as tvis
from sequoia_tpu_torch.models import vit as tvit
from sequoia_tpu_torch.train import checkpoint as tckpt
from sequoia_tpu_torch.train import loop as tloop
from tests.test_data_and_train import make_store

REL = 5e-4  # tests/test_train_step_parity.py:60


def _models(kind, compute_dtype=None):
    """(JAX cfg, port cfg, JAX apply, port apply, JAX init params) at tiny width."""
    if kind == "vis":
        kw = dict(num_outputs=6, input_dim=16, depth=2, nheads=2, dim_f=4, dim_s=4, dim_c=4,
                  num_clusters=5, compute_dtype=compute_dtype)
        jm, tm, jc, tc = jvis, tvis, jvis.ViSConfig(**kw), tvis.ViSConfig(**kw)
    else:
        kw = dict(num_outputs=6, dim=16, depth=2, heads=2, dim_head=8, mlp_dim=24,
                  num_clusters=5, compute_dtype=compute_dtype)
        jm, tm, jc, tc = jvit, tvit, jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    return (jc, tc, lambda p, x: jm.apply(jc, p, x), lambda p, x: tm.apply(tc, p, x),
            jax.tree.map(np.asarray, jm.init(jc, jax.random.PRNGKey(0))))


def _carry(jp):
    return tconvert.vis_params_from_numpy(jp)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-8)


def _assert_tree_close(tparams, jparams, rel=REL):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for p in path:
            node = node[p.key]
        err = _rel(node.detach().numpy(), leaf)
        assert err < rel, (jax.tree_util.keystr(path), err)


def _batches(n=3, b=4, tokens=5, d=16, g=6):
    rng = np.random.default_rng(1)
    out = []
    for i in range(n):
        valid = np.ones(b, bool)
        if i == 1:
            valid[-1] = False  # a padded row: in the forward, out of the loss
        out.append((rng.normal(size=(b, tokens, d)).astype(np.float32),
                    rng.normal(size=(b, g)).astype(np.float32), valid))
    return out


@pytest.mark.parametrize("kind", ["vis", "vit"])
def test_three_train_steps_match_jax(kind):
    _, _, japply, tapply, jp0 = _models(kind)
    opt = jloop.make_adamw(1e-3)
    jtrain, _ = jloop.make_step_fns(japply, opt)
    jp, jstate = jax.tree.map(jnp.asarray, jp0), None
    jstate = opt.init(jp)

    tp = tloop.tree_map(lambda t: t.requires_grad_(True), _carry(jp0))
    topt = tloop.make_adamw(tp, lr=1e-3)
    ttrain, _ = tloop.make_step_fns(tapply, topt)
    for x, y, v in _batches():
        jp, jstate, jm = jtrain(jp, jstate, jnp.asarray(x), jnp.asarray(y), jnp.asarray(v))
        tm = ttrain(tp, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(v))
        assert set(tm) == set(jm) == {"loss", "mae", "corr"}
        for k in jm:
            assert tm[k].dtype == torch.float32 and tm[k].dim() == 0
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=REL, atol=1e-6)
    _assert_tree_close(tp, jax.tree.map(np.asarray, jp))
    assert _rel(tp["head_w"].detach().numpy(), jp0["head_w"]) > 1e-4  # the steps moved it


def test_eval_step_matches_jax():
    _, _, japply, tapply, jp0 = _models("vis")
    x, y, v = _batches()[1]
    jpred, jm = jloop.make_eval_step(japply)(jax.tree.map(jnp.asarray, jp0), x, y, v)
    tpred, tm = tloop.make_eval_step(tapply)(_carry(jp0), torch.as_tensor(x),
                                              torch.as_tensor(y), torch.as_tensor(v))
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=1e-4, atol=1e-5)
    assert sorted(tm) == sorted(jm) == ["corr", "loss", "mae", "smape"]
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=REL, atol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_low_mem_adamw_at_f32_matches_parity_path(weight_decay):
    g = torch.Generator().manual_seed(0)
    base = {"w": torch.randn(16, 8, generator=g), "b": torch.zeros(8)}
    ref = {k: v.clone().requires_grad_(True) for k, v in base.items()}
    new = {k: v.clone().requires_grad_(True) for k, v in base.items()}
    opt_r = tloop.make_adamw(ref, lr=1e-3, weight_decay=weight_decay)
    opt_n = tloop.LowMemAdamW(tloop.tree_leaves(new), lr=1e-3, weight_decay=weight_decay,
                              moment_dtype=torch.float32)
    for i in range(5):
        for params, opt in ((ref, opt_r), (new, opt_n)):
            for p in params.values():
                p.grad = torch.sin(p.detach() + i)
            opt.step()
    for k in base:
        np.testing.assert_allclose(new[k].detach().numpy(), ref[k].detach().numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_low_mem_adamw_matches_jax_low_mem_in_bf16():
    g = torch.Generator().manual_seed(1)
    base = {"w": torch.randn(16, 8, generator=g), "b": torch.randn(8, generator=g)}
    jopt = jloop.make_adamw(1e-2, moment_dtype="bfloat16")
    jp = {k: jnp.asarray(v.numpy()) for k, v in base.items()}
    jstate = jopt.init(jp)
    tp = {k: v.clone().requires_grad_(True) for k, v in base.items()}
    topt = tloop.make_adamw(tp, lr=1e-2, moment_dtype="bfloat16")
    for i in range(4):
        grads = {k: jnp.sin(v + i) for k, v in jp.items()}
        upd, jstate = jopt.update(grads, jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = torch.sin(p.detach() + i)
        topt.step()
    for k in base:
        assert topt.state[tp[k]]["exp_avg"].dtype == torch.bfloat16
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-6)
        mu = np.asarray(jstate["mu"][k].astype(jnp.float32))
        np.testing.assert_allclose(topt.state[tp[k]]["exp_avg"].float().numpy(), mu,
                                   rtol=1e-2, atol=1e-6)


def test_make_adamw_selects_and_refuses():
    p = {"w": torch.zeros(3, requires_grad=True)}
    for dt in (None, "float32", torch.float32):
        opt = tloop.make_adamw(p, moment_dtype=dt)
        assert type(opt) is torch.optim.AdamW
        group = opt.param_groups[0]
        assert (group["weight_decay"], group["betas"], group["eps"], group["amsgrad"],
                group["foreach"]) == (0.0, (0.9, 0.999), 1e-8, False, True)
    opt = tloop.make_adamw(p, moment_dtype="bfloat16")
    assert isinstance(opt, tloop.LowMemAdamW)
    p["w"].grad = torch.ones(3)
    opt.step()
    st = opt.state[p["w"]]
    assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.bfloat16
    for missing in (None, [], {}):
        with pytest.raises(ValueError, match="parameters"):
            tloop.make_adamw(missing)
    with pytest.raises(ValueError, match="moment_dtype"):
        tloop.make_adamw(p, moment_dtype="int8")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store"))
    return root, make_store(root, n_slides=14, n_genes=6, dim=16, tokens=5)


def _loaders(mod, root, df):
    d = mod.FeatureDataset(df, root)
    return {"train": mod.BatchLoader(d, 4, shuffle=True, seed=0), "val": mod.BatchLoader(d, 4)}


@pytest.mark.parametrize("kind,save_on,stop_on,lr", [
    ("vis", "loss", "loss", 3e-3), ("vis", "loss+corr", "loss+corr", 3e-2),
    ("vit", "loss", "loss", 3e-2)])
def test_train_matches_jax(store, kind, save_on, stop_on, lr):
    root, df = store
    _, _, japply, tapply, jp0 = _models(kind)
    kw = dict(num_epochs=4, patience=1, delta=0.05, save_on=save_on, stop_on=stop_on,
              verbose=False)
    jsaved, tsaved = [], []
    jres = jloop.train(japply, jax.tree.map(jnp.asarray, jp0), jloop.make_adamw(lr),
                       _loaders(jds, root, df), save_fn=jsaved.append, **kw)
    tres = tloop.train(tapply, _carry(jp0), functools.partial(tloop.make_adamw, lr=lr),
                       _loaders(tds, root, df), save_fn=tsaved.append, device="cpu", **kw)
    assert tres.best_epoch == jres.best_epoch >= 0
    assert len(tres.history) == len(jres.history) and len(tsaved) == len(jsaved)
    for th, jh in zip(tres.history, jres.history):
        for phase in jh:
            assert sorted(th[phase]) == sorted(jh[phase])
            for k in jh[phase]:
                np.testing.assert_allclose(th[phase][k], jh[phase][k], rtol=1e-4, atol=1e-6)
    _assert_tree_close(tres.final_params, jres.final_params)
    _assert_tree_close(tres.params, jres.params)
    _assert_tree_close(tsaved[-1], jax.tree.map(np.asarray, jsaved[-1]))
    assert tres.final_params["head_w"].device.type == "cpu"


def test_train_keeps_caller_params_and_device_snapshot(store):
    root, df = store
    _, _, _, tapply, jp0 = _models("vis")
    p0 = _carry(jp0)
    before = p0["head_w"].clone()
    res = tloop.train(tapply, p0, functools.partial(tloop.make_adamw, lr=1e-2),
                      _loaders(tds, root, df), num_epochs=2, verbose=False, device="cpu")
    assert torch.equal(p0["head_w"], before) and not p0["head_w"].requires_grad
    assert res.best_epoch >= 0 and not res.params["head_w"].requires_grad
    assert not torch.equal(res.final_params["head_w"], before)


def test_evaluate_and_predict_match_jax(store):
    root, df = store
    _, _, japply, tapply, jp0 = _models("vit")
    want = jloop.evaluate(japply, jax.tree.map(jnp.asarray, jp0),
                          jds.BatchLoader(jds.FeatureDataset(df, root), 4), verbose=False)
    d = tds.FeatureDataset(df, root)
    logged = []
    got = tloop.evaluate(tapply, _carry(jp0), tds.BatchLoader(d, 4), verbose=False,
                         device="cpu", log_fn=lambda *a: logged.append(a))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (14, 6) and logged[0][1] == "test"
    preds, wsis, projs = tloop.predict(tapply, _carry(jp0), tds.BatchLoader(d, 4),
                                       device="cpu")
    np.testing.assert_allclose(preds, got[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(wsis, got[2])
    np.testing.assert_array_equal(projs, got[3])


def test_train_h2d_bf16_cast_is_bit_identical(store):
    root, df = store
    _, _, _, tapply, jp0 = _models("vis", compute_dtype="bfloat16")

    def run(h2d):
        return tloop.train(tapply, _carry(jp0), functools.partial(tloop.make_adamw, lr=1e-3),
                           _loaders(tds, root, df), num_epochs=2, verbose=False,
                           h2d_dtype=h2d, device="cpu")

    a, b = run(None), run("bfloat16")
    assert a.history == b.history
    for k, v in tloop.tree_map(lambda t: t, a.final_params).items():
        if isinstance(v, dict):
            for kk in v:
                assert torch.equal(v[kk], b.final_params[k][kk])
        else:
            assert torch.equal(v, b.final_params[k])


def test_train_state_round_trip_keeps_bf16_moments(tmp_path):
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(2, 3, generator=g), "blocks": {"w": torch.randn(4, generator=g)}}
    live = tloop.tree_map(lambda t: t.clone().requires_grad_(True), params)
    opt = tloop.make_adamw(live, lr=1e-2, moment_dtype="bfloat16")
    for p in tloop.tree_leaves(live):
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()
    path = str(tmp_path / "s.npz")
    tckpt.save_train_state(path, {"params": live, "best": None}, opt.state_dict(),
                           {"epoch": 7, "history": [{"val": {"loss": 0.5}}]})
    packed, ostate, meta = tckpt.load_train_state(path)
    assert meta == {"epoch": 7, "history": [{"val": {"loss": 0.5}}]} and packed["best"] is None
    assert torch.equal(packed["params"]["blocks"]["w"], live["blocks"]["w"].detach())
    want = opt.state_dict()
    assert ostate["param_groups"] == want["param_groups"]
    for i, st in want["state"].items():
        for k, v in st.items():
            assert ostate["state"][i][k].dtype == v.dtype
            assert torch.equal(ostate["state"][i][k], v)
    # and through load_state_dict into a fresh optimizer: still bf16, bit-equal
    fresh = tloop.tree_map(lambda t: t.clone().requires_grad_(True), params)
    opt2 = tloop.make_adamw(fresh, lr=1e-2, moment_dtype="bfloat16")
    opt2.load_state_dict(ostate)
    for p, q in zip(tloop.tree_leaves(live), tloop.tree_leaves(fresh)):
        for k in ("exp_avg", "exp_avg_sq"):
            assert opt2.state[q][k].dtype == torch.bfloat16
            assert torch.equal(opt2.state[q][k], opt.state[p][k])
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_train_resume_continues(store, tmp_path, moment_dtype):
    root, df = store
    _, _, _, tapply, jp0 = _models("vis")
    state = str(tmp_path / "state.npz")
    opt = functools.partial(tloop.make_adamw, lr=1e-3, moment_dtype=moment_dtype)
    r1 = tloop.train(tapply, _carry(jp0), opt, _loaders(tds, root, df), num_epochs=2,
                     verbose=False, state_path=state, device="cpu")
    _, ostate, meta = tckpt.load_train_state(state)
    assert meta["epoch"] == 1 and len(r1.history) == 2
    want = torch.bfloat16 if moment_dtype else torch.float32
    assert all(st["exp_avg"].dtype == want for st in ostate["state"].values())
    r2 = tloop.train(tapply, _carry(jp0), opt, _loaders(tds, root, df), num_epochs=4,
                     verbose=False, state_path=state, device="cpu")
    assert len(r2.history) == 4 and r2.history[:2] == r1.history
    assert r2.history[-1]["val"]["loss"] < r1.history[0]["val"]["loss"]


def test_resume_after_early_stop_does_not_continue(store, tmp_path):
    root, df = store
    _, _, _, tapply, jp0 = _models("vis")
    state = str(tmp_path / "state.npz")
    opt = functools.partial(tloop.make_adamw, lr=0.0)  # nothing improves: patience trips
    kw = dict(num_epochs=50, patience=2, verbose=False, state_path=state, device="cpu")
    r1 = tloop.train(tapply, _carry(jp0), opt, _loaders(tds, root, df), **kw)
    assert len(r1.history) == 3
    r2 = tloop.train(tapply, _carry(jp0), opt, _loaders(tds, root, df), **kw)
    assert r2.history == r1.history


def test_mesh_is_not_ported(store):
    """``train(mesh=)``, once refused, takes a ``multihost.GlobalMesh``
    (tests/test_torch_multihost.py runs it over ranks); anything else is a
    TypeError, and a model axis needs a gene head."""
    root, df = store
    _, _, _, tapply, jp0 = _models("vis")
    with pytest.raises(TypeError, match="GlobalMesh"):
        tloop.train(tapply, _carry(jp0), tloop.make_adamw, _loaders(tds, root, df),
                    mesh=object(), device="cpu")
    from sequoia_tpu_torch.parallel.multihost import GlobalMesh

    mesh = GlobalMesh(np.arange(2).reshape(1, 2), 0, torch.device("cpu"), None, None)
    with pytest.raises(ValueError, match="head_w"):
        tloop.train(tapply, {"w": torch.zeros(2)}, tloop.make_adamw, {}, mesh=mesh)
