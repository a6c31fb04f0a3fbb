"""Port k-means (ops/kmeans.py, ops/cuda_kmeans.py) against the JAX package
on the CPU: the K5 plain version against the Pallas kernel in interpret
mode, Lloyd from shared centers, the host seeding, kmeans++ fits, and the
cluster means."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.ops import kmeans as jkm
from sequoia_tpu.ops import pallas_kmeans as jpk
from sequoia_tpu_torch.ops import cuda_kmeans as tpk
from sequoia_tpu_torch.ops import kmeans as tkm


def _blobs(n, d, k, seed, spread=0.05, scale=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * scale
    return (centers[rng.integers(0, k, n)] + spread * rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("n", [1024, 1000])
def test_lloyd_stats_plain_matches_jax_interpret(n):
    """tests/test_pallas_kmeans.py:23-43 on clustered points (no near-ties
    for the two f32 summation orders to split); n=1000 is ragged for the
    port (the JAX kernel needs n % tile_n == 0, so it gets the padded rows
    masked)."""
    rng = np.random.default_rng(0)
    d, k = 256, 128
    true = rng.normal(size=(k, d)).astype(np.float32)
    x = (true[rng.integers(0, k, 1024)] + 0.1 * rng.normal(size=(1024, d))).astype(np.float32)
    centers = (true + 0.01 * rng.normal(size=(k, d))).astype(np.float32)
    mask = np.ones(1024, bool)
    mask[n - 24:] = False
    ws, wc, wi, wb = jpk.lloyd_stats(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(centers),
                                     tile_n=256, interpret=True)
    s, c, i, b = tpk.lloyd_stats(torch.as_tensor(x[:n]), torch.as_tensor(mask[:n]),
                                 torch.as_tensor(centers))
    np.testing.assert_array_equal(c.numpy(), np.asarray(wc))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(i), float(wi), rtol=1e-5)
    assert float(c.sum()) == n - 24
    assert b.shape == (n,) and (b.numpy()[n - 24:] == 0).all()
    np.testing.assert_allclose(b.numpy(), np.asarray(wb)[:n], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_kmeans_lloyd_from_shared_centers_matches_jax(use_pallas):
    x = _blobs(512, 128, 10, seed=1, spread=0.5, scale=1.0)
    init = x[np.random.default_rng(2).choice(512, 10, replace=False)]
    mask = np.ones(512, bool)
    mask[-12:] = False
    jc, jl, ji, jn = jkm.kmeans_lloyd(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(init))
    tc, tl, ti, tn = tkm.kmeans_lloyd(torch.as_tensor(x), torch.as_tensor(mask),
                                      torch.as_tensor(init), use_pallas=use_pallas)
    np.testing.assert_array_equal(tl.numpy()[mask], np.asarray(jl)[mask])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    assert tn == int(jn)


@pytest.mark.parametrize("n", [5, 12])
def test_kmeans_lloyd_degenerate_matches_jax(n):
    """Fewer (or barely more) points than clusters, in 4 tight groups: the
    empty-cluster relocation, min_empty and the donor repair.  (The points
    are jittered: for exact duplicates the "farthest point" is decided by
    the cancellation noise of |x|^2 + |c|^2 - 2 x.c, which differs between
    any two implementations.)"""
    rng = np.random.default_rng(n)
    base = rng.normal(size=(4, 16)).astype(np.float32)
    x = (base[rng.integers(0, 4, n)] + 1e-2 * rng.normal(size=(n, 16))).astype(np.float32)
    init = np.concatenate([x[:4], x[:4] + 1e-3]).astype(np.float32)  # k = 8
    mask = np.ones(n, bool)
    jc, jl, ji, jn = jkm.kmeans_lloyd(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(init))
    tc, tl, ti, tn = tkm.kmeans_lloyd(torch.as_tensor(x), torch.as_tensor(mask),
                                      torch.as_tensor(init))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # the centers of clusters with members; with n < k the others are
    # relocation candidates ranked by that same cancellation noise
    used = np.unique(tl.numpy())
    assert len(used) == min(n, 8)
    np.testing.assert_allclose(tc.numpy()[used], np.asarray(jc)[used], rtol=1e-5, atol=1e-5)
    # inertia: a sum of small d2 values, each exact to f32 precision of |x|^2
    np.testing.assert_allclose(float(ti), float(ji), rtol=0, atol=1e-5)
    assert tn == int(jn)


def test_final_donor_repair_matches_jax():
    """No Lloyd step (max_iter=0): a duplicated center and a far one end
    empty, and the repair fills them from donor clusters' farthest points."""
    x = np.random.default_rng(7).normal(size=(20, 8)).astype(np.float32)
    init = np.stack([x[0], x[0], x[1], x[1] + 100]).astype(np.float32)
    mask = np.ones(20, bool)
    jc, jl, ji, _ = jkm.kmeans_lloyd(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(init),
                                     max_iter=0)
    tc, tl, ti, tn = tkm.kmeans_lloyd(torch.as_tensor(x), torch.as_tensor(mask),
                                      torch.as_tensor(init), max_iter=0)
    assert tn == 0
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert len(np.unique(tl.numpy())) == 4
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)


def test_plusplus_indices_identical_to_jax():
    x = _blobs(300, 32, 6, seed=3)
    want = jkm.plusplus_indices(x, 12, np.random.RandomState(0))
    got = tkm.plusplus_indices(x, 12, np.random.RandomState(0))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tkm.sklearn_plusplus_centers(x, 12, 5),
                                  jkm.sklearn_plusplus_centers(x, 12, 5))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_kmeans_fit_inertia_matches_jax(use_pallas):
    """Separated blobs: any kmeans++ draw finds the same optimum, so the two
    RNG streams agree in inertia."""
    x = _blobs(512, 128, 10, seed=1)
    mask = np.ones(512, bool)
    _, jl, ji, _ = jkm.kmeans_fit(jnp.asarray(x), jnp.asarray(mask), jax.random.PRNGKey(0),
                                  n_clusters=10)
    _, tl, ti, _ = tkm.kmeans_fit(torch.as_tensor(x), torch.as_tensor(mask),
                                  torch.Generator().manual_seed(0), n_clusters=10,
                                  use_pallas=use_pallas)
    np.testing.assert_allclose(float(ti), float(ji), rtol=5e-4)
    assert len(np.unique(tl.numpy())) == 10


def test_cluster_means_nan_for_empty_clusters():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    labels = np.array([0, 2, 2, 0])
    mask = np.array([True, True, True, False])
    want = np.asarray(jkm.cluster_means(jnp.asarray(x), jnp.asarray(labels),
                                        jnp.asarray(mask), n_clusters=4))
    got = tkm.cluster_means(torch.as_tensor(x), torch.as_tensor(labels),
                            torch.as_tensor(mask), n_clusters=4).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and np.isnan(got[3]).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]])


def test_kmeans_cluster_features_hybrid_matches_jax():
    feats = _blobs(200, 64, 8, seed=5, spread=0.3, scale=1.0)
    want = jkm.kmeans_cluster_features(feats, n_clusters=8, seed=0, backend="hybrid")
    got = tkm.kmeans_cluster_features(feats, n_clusters=8, seed=0, backend="hybrid",
                                      device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    dev = tkm.kmeans_cluster_features(feats, n_clusters=8, seed=0, device="cpu")
    assert dev.shape == (8, 64) and np.isfinite(dev).all()
    with pytest.raises(ValueError):
        tkm.kmeans_cluster_features(feats, n_clusters=8, backend="tpu", device="cpu")
