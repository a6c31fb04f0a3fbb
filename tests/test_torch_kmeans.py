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


def _seed_case(case):
    """(x, mask, k) of a kmeans++ case: blobs with masked padding rows; fewer
    valid rows than centers; rows that repeat three distinct ones."""
    if case == "blobs":
        x = _blobs(300, 32, 6, seed=4, spread=0.3, scale=1.0)
        mask = np.ones(300, bool)
        mask[-40:] = False
        return x, mask, 20
    if case == "n_below_k":
        x = _blobs(8, 16, 3, seed=5)
        mask = np.array([True] * 5 + [False] * 3)
        return x, mask, 12
    x = np.repeat(_blobs(3, 16, 3, seed=6), 5, axis=0)
    return x, np.ones(15, bool), 6


def _np_race_exp(u_i, n):
    """Each row's Exp(1) draw of the pick keyed by the uniform ``u_i``, in
    NumPy's own unsigned arithmetic: splitmix64 of u_i's bits + (r + 1)
    golden, -log of ((z >> 11) + 1/2) 2^-53."""
    with np.errstate(over="ignore"):
        z = np.float64(u_i).view(np.uint64) + np.arange(1, n + 1, dtype=np.uint64) \
            * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return -np.log(((z >> np.uint64(11)).astype(np.float64) + 0.5) * 2.0 ** -53)


def _np_plusplus(x, mask, u):
    """NumPy f64 kmeans++ by exponential races on given uniforms: the
    indices, and each pick's weights."""
    x64 = x.astype(np.float64)
    valid = mask.astype(np.float64)
    d2 = np.full(len(x), np.inf)
    idx, weights = [], []
    w = valid
    for i, ui in enumerate(u):
        if i:
            d2 = np.minimum(d2, ((x64 - x64[idx[-1]]) ** 2).sum(1))
            w = np.where(mask & (d2 > 0), d2, 0.0)
            if w.sum() == 0:
                w = valid
        with np.errstate(divide="ignore"):
            score = np.where(w > 0, _np_race_exp(ui, len(x)) / w, np.inf)
        idx.append(int(np.argmin(score)))
        weights.append(w)
    return np.array(idx), weights


@pytest.mark.parametrize("case", ["blobs", "n_below_k", "duplicates"])
def test_plusplus_draws_one_rand_of_k(case):
    """The seeding takes exactly one ``torch.rand(k)`` of f64 uniforms from
    the generator (the kernel takes the same uniforms: one draw on either
    backend)."""
    x, mask, k = _seed_case(case)
    gen = torch.Generator().manual_seed(11)
    tkm._plusplus_init(gen, torch.as_tensor(x), torch.as_tensor(mask), k)
    ref = torch.Generator().manual_seed(11)
    torch.rand(k, generator=ref, dtype=torch.float64)
    assert torch.equal(gen.get_state(), ref.get_state())


@pytest.mark.parametrize("case", ["blobs", "n_below_k", "duplicates"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plusplus_picks_match_numpy_inverse_cdf(case, seed):
    """The plain mirror picks what a NumPy f64 exponential race (its hash in
    NumPy's unsigned arithmetic) picks on the same uniforms, its centers are
    those rows, and no pick is a masked row or a
    row without weight while weight remains; where none remains (fewer
    distinct valid rows than centers) the picks fall back to the valid rows."""
    x, mask, k = _seed_case(case)
    u = torch.rand(k, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    centers, idx = tpk.kmeans_seed_plain(torch.as_tensor(x), torch.as_tensor(mask), u)
    want, weights = _np_plusplus(x, mask, u.numpy())
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(centers.numpy(), x[want])
    for pick, w in zip(want, weights):
        assert mask[pick] and w[pick] > 0
    distinct = len(np.unique(x[mask], axis=0))
    assert len(np.unique(x[want], axis=0)) == min(distinct, k)
    if case != "blobs":  # every distinct valid row first, then the valid rows again
        assert len(np.unique(x[want[:distinct]], axis=0)) == distinct
        assert all(weights[i].sum() == mask.sum() for i in range(distinct, k))


@pytest.mark.parametrize("fault", ["cpu", "f64_x", "f32_u", "mask_shape"])
def test_kmeans_seed_kernel_refuses_what_it_cannot_take(fault):
    """The kernel's wrapper takes CUDA tensors only (the mirror is chosen
    once, in ``_plusplus_init``), x f32, u f64 and a mask of x's rows."""
    x, mask = torch.zeros((8, 4)), torch.ones(8, dtype=torch.bool)
    u = torch.rand(3, dtype=torch.float64)
    if fault == "f64_x":
        x = x.double()
    elif fault == "f32_u":
        u = u.float()
    elif fault == "mask_shape":
        mask = mask[:5]
    with pytest.raises(TypeError if fault == "f64_x" else ValueError):
        tpk.kmeans_seed(x, mask, u)


def test_plusplus_seeding_keeps_its_picks_under_rounding():
    """A rounding change in the features (1e-3 relative, as a bf16 batch
    position or another decode path gives) seldom moves the seeding's
    picks: the race moves a pick only where the winner changes.  Here it
    moves them on 2 of 30 seeds; an inverse CDF over the cumulative weights,
    whose every boundary moves with any earlier row, moved them on 17."""
    rng = np.random.default_rng(3)
    x = np.maximum(_blobs(400, 64, 12, seed=9, spread=0.5), 0).astype(np.float32)
    xp = (x * (1 + 1e-3 * rng.standard_normal(x.shape))).astype(np.float32)
    mask = torch.ones(400, dtype=torch.bool)
    moved = 0
    for seed in range(30):
        u = torch.rand(40, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
        a = tpk.kmeans_seed_plain(torch.as_tensor(x), mask, u)[1]
        moved += not torch.equal(a, tpk.kmeans_seed_plain(torch.as_tensor(xp), mask, u)[1])
    assert moved <= 3, moved


def test_plusplus_second_center_follows_d2():
    """D^2 sampling: over 12,000 seeded draws on 4 points the (first, second)
    pairs follow uniform(first) x d2(second | first) / T (chi-square, 11
    degrees of freedom, p > 0.001)."""
    from scipy import stats

    pts = np.array([0.0, 1.0, 2.0, 4.0])
    x = torch.as_tensor(np.pad(pts[:, None], ((0, 0), (0, 3))).astype(np.float32))
    mask = torch.ones(4, dtype=torch.bool)
    gen = torch.Generator().manual_seed(2024)
    draws = 12_000
    seen = np.zeros((4, 4))
    for _ in range(draws):
        c = tkm._plusplus_init(gen, x, mask, 2)[:, 0].numpy()
        seen[np.searchsorted(pts, c[0]), np.searchsorted(pts, c[1])] += 1
    d2 = (pts[:, None] - pts[None]) ** 2
    expect = draws * 0.25 * d2 / d2.sum(1, keepdims=True)
    off = ~np.eye(4, dtype=bool)
    assert seen[~off].sum() == 0
    chi2 = float((((seen - expect) ** 2)[off] / expect[off]).sum())
    assert stats.chi2.sf(chi2, df=off.sum() - 1) > 1e-3, (chi2, seen)


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
