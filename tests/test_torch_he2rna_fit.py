"""Port train/he2rna_fit.py and loop.make_adam against the JAX package on the
CPU, on one HDF5 store and the same batch stream, with dropout 0 and one k
(neither side then draws): three Adam steps per leaf within 5e-4 of the
leaf's max (as tests/test_train_step_parity.py), ``he2rna_evaluate``,
``he2rna_predict`` and ``host_compute_correlations``, ``fit`` with its
selection rules, and the ``saved_any`` fallback."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.data import dataset as jds
from sequoia_tpu.models import he2rna as jhe
from sequoia_tpu.train import he2rna_fit as jfit
from sequoia_tpu.train import loop as jloop
from sequoia_tpu_torch.data import dataset as tds
from sequoia_tpu_torch.models import convert, he2rna
from sequoia_tpu_torch.train import he2rna_fit as tfit
from sequoia_tpu_torch.train import loop as tloop
from tests.test_data_and_train import make_store

DIM, GENES, TOKENS = 16, 5, 10
CFG = dict(input_dim=DIM, output_dim=GENES, layers=(12, 8), ks=(3,), dropout=0.0)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("he2rna_fit")
    rng = np.random.default_rng(3)
    df = make_store(str(root), n_slides=14, n_genes=GENES, dim=DIM, tokens=TOKENS, rng=rng)
    # HE2RNA tiles are non-negative (ResNet features after ReLU) with padded
    # tails: score ties sit only where the mask zeroes the gradient
    import h5py

    for i, wsi in enumerate(df["wsi_file_name"]):
        path = jds.slide_h5_path(str(root), "TCGA-TEST", wsi)
        with h5py.File(path, "r+") as f:
            x = np.abs(f["cluster_features"][:])
            x[TOKENS - i % 4:] = 0.0
            del f["cluster_features"]
            f.create_dataset("cluster_features", data=x)
    return str(root), df


def _init(seed=0):
    jcfg = jhe.HE2RNAConfig(**CFG)
    jp = jhe.init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, he2rna.HE2RNAConfig(**CFG), convert.he2rna_params_from_numpy(
        jax.tree.map(np.asarray, jp))


def _loaders(root, df, idx, shuffle=False, seed=0, batch_size=4):
    part = df.iloc[idx]
    return (jds.BatchLoader(jds.FeatureDataset(part, root), batch_size, shuffle=shuffle,
                            seed=seed),
            tds.BatchLoader(tds.FeatureDataset(part, root), batch_size, shuffle=shuffle,
                            seed=seed))


def _assert_leaves(got, want, tol=5e-4):
    for g, w in zip(got["w"] + got["b"], want["w"] + want["b"]):
        w = np.asarray(w)
        assert np.abs(np.asarray(g) - w).max() <= tol * max(np.abs(w).max(), 1e-8)


def test_make_adam_is_adam_without_weight_decay():
    p = {"w": [torch.zeros(3, requires_grad=True)], "b": [torch.zeros(2, requires_grad=True)]}
    opt = tloop.make_adam(p, lr=3e-3)
    assert type(opt) is torch.optim.Adam and len(opt.param_groups[0]["params"]) == 2
    g = opt.param_groups[0]
    assert (g["lr"], g["betas"], g["eps"], g["weight_decay"]) == (3e-3, (0.9, 0.999), 1e-8, 0)
    with pytest.raises(ValueError, match="parameters"):
        tloop.make_adam({}, 1e-3)


def test_three_adam_steps_match_jax(store):
    root, df = store
    jl, tl = _loaders(root, df, np.arange(12), shuffle=True, seed=1)
    jcfg, jp, cfg, tp = _init(1)
    opt = jloop.make_adam(1e-3)
    jstep, _ = jfit.make_he2rna_step_fns(jcfg, opt)
    jstate = opt.init(jp)
    rng = jax.random.PRNGKey(0)
    params = tloop.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tstep, _ = tfit.make_he2rna_step_fns(cfg, tloop.make_adam(params, 1e-3),
                                         k_gen=torch.Generator().manual_seed(0))
    steps = 0
    for jb, tb in zip(jl, tl):
        np.testing.assert_array_equal(jb.features, tb.features)
        jp, jstate, jloss, rng = jstep(jp, jstate, jnp.asarray(jb.features),
                                       jnp.asarray(jb.rna), jnp.asarray(jb.valid), rng)
        tloss = tstep(params, *(torch.from_numpy(a) for a in (tb.features, tb.rna, tb.valid)))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        steps += 1
    assert steps == 3
    _assert_leaves(tloop.tree_map(lambda t: t.detach(), params), jp)


def test_evaluate_predict_and_correlations_match_jax(store):
    root, df = store
    jl, tl = _loaders(root, df, np.arange(2, 13))
    jcfg, jp, cfg, tp = _init(2)
    jloss, jscore = jfit.he2rna_evaluate(jcfg, jp, jl)
    tloss, tscore = tfit.he2rna_evaluate(cfg, tp, tl, device="cpu")
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    np.testing.assert_allclose(tscore, jscore, rtol=1e-4, atol=1e-6)

    jp_, jr, jw, jpr = jfit.he2rna_predict(jcfg, jp, jl)
    tp_, tr, tw, tpr = tfit.he2rna_predict(cfg, tp, tl, device="cpu")
    assert tp_.shape == jp_.shape == (11, GENES) and (tp_ >= 0).all()
    np.testing.assert_allclose(tp_, jp_, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tpr, jpr)

    rng = np.random.default_rng(0)
    labels = rng.normal(size=(9, 4))
    labels[:, 2] = 1.0  # a constant gene is skipped
    preds = rng.normal(size=(9, 4))
    # every gene at once against JAX's per-gene np.corrcoef loop
    np.testing.assert_allclose(tfit.host_compute_correlations(labels, preds),
                               jfit.host_compute_correlations(labels, preds), rtol=1e-12)
    big_l, big_p = rng.normal(size=(7, 300)), rng.normal(size=(7, 300)).astype(np.float32)
    big_l[:, :5] = 2.0
    big_p[:, 5:9] = 0.0  # constant predictions: NaN, dropped
    np.testing.assert_allclose(tfit.host_compute_correlations(big_l, big_p),
                               jfit.host_compute_correlations(big_l, big_p), rtol=1e-12)
    assert np.isnan(tfit.host_compute_correlations(np.ones((3, 2)), preds[:3, :2]))


def test_empty_loaders():
    class Empty:
        ds = type("DS", (), {"num_genes": GENES})()

        def __iter__(self):
            return iter(())

    cfg = he2rna.HE2RNAConfig(**CFG)
    params = he2rna.init(cfg, torch.Generator().manual_seed(0))
    p, r, w, pr = tfit.he2rna_predict(cfg, params, Empty(), device="cpu")
    assert p.shape == r.shape == (0, GENES) and w.shape == pr.shape == (0,)
    loss, score = tfit.he2rna_evaluate(cfg, params, Empty(), device="cpu")
    assert np.isnan(loss) and np.isnan(score)


def _fit_both(store, lr, max_epochs, valid=True):
    root, df = store
    jtr, ttr = _loaders(root, df, np.arange(8), shuffle=True, seed=4)
    jva, tva = _loaders(root, df, np.arange(8, 11))
    jte, tte = _loaders(root, df, np.arange(11, 14))
    jcfg, jp, cfg, tp = _init(5)
    jsaves, tsaves = [], []
    want = jfit.fit(jcfg, jp, lr, jtr, jva if valid else None, jte, max_epochs=max_epochs,
                    seed=4, verbose=False, save_fn=lambda p: jsaves.append(p))
    got = tfit.fit(cfg, tp, lr, ttr, tva if valid else None, tte, max_epochs=max_epochs,
                   seed=4, verbose=False, save_fn=lambda p: tsaves.append(p), device="cpu")
    return want, got, jsaves, tsaves, tp


def test_fit_matches_jax(store):
    """Four epochs at lr 3e-3: the same epochs improve the validation
    correlation (the same saves), and the best model's test predictions and
    weights agree within 5e-4 of their max."""
    want, got, jsaves, tsaves, _ = _fit_both(store, 3e-3, 4)
    assert len(tsaves) == len(jsaves) >= 1
    for g, w in zip(tsaves, jsaves):
        _assert_leaves(g, w)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == want[0].shape == (3, GENES)
    assert np.abs(got[0] - want[0]).max() <= 5e-4 * np.abs(want[0]).max()


def test_fit_saved_any_fallback(store):
    """At lr 0 no epoch beats the first evaluation: the final model (here the
    initial one) is saved once, and predicts the test fold."""
    want, got, jsaves, tsaves, tp = _fit_both(store, 0.0, 2)
    assert len(tsaves) == len(jsaves) == 1
    for a, b in zip(tsaves[0]["w"] + tsaves[0]["b"], tp["w"] + tp["b"]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


def test_fit_without_loaders_returns_the_final_params(store):
    """GTEx pretraining's call: no validation and no test loader; the final
    model is saved once and returned."""
    root, df = store
    _, ttr = _loaders(root, df, np.arange(8), shuffle=True)
    cfg = he2rna.HE2RNAConfig(**{**CFG, "ks": (1, 3), "dropout": 0.5})
    params = he2rna.init(cfg, torch.Generator().manual_seed(0))
    saves = []
    out = tfit.fit(cfg, params, 3e-3, ttr, None, None, max_epochs=2, verbose=False,
                   save_fn=saves.append, device="cpu")
    assert len(saves) == 1 and all(torch.equal(a, b) for a, b in
                                    zip(out["w"] + out["b"], saves[0]["w"] + saves[0]["b"]))
    assert not torch.equal(out["w"][0], params["w"][0])  # it trained
    assert all(t.device.type == "cpu" and not t.requires_grad for t in out["w"] + out["b"])
