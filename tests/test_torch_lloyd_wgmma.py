"""K5's centered 3xTF32 recipe (ops/cuda_kmeans.py: ``lloyd_stats_tc_plain``,
the plain mirror of csrc/lloyd_wgmma.cu, and ``LloydPlan``) on the CPU:
against the JAX kernel in interpret mode, its TF32 rounding, its mean over
the valid rows only, and a near-tie fixture on which it follows a float64
Lloyd fit where the uncentered f32 recipe does not."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequoia_tpu.ops import kmeans as jkm
from sequoia_tpu.ops import pallas_kmeans as jpk
from sequoia_tpu_torch.ops import cuda_kmeans as tpk
from sequoia_tpu_torch.ops import kmeans as tkm


def _clustered():
    """tests/test_torch_kmeans.py's fixture: 1024 points near 128 centers."""
    rng = np.random.default_rng(0)
    d, k = 256, 128
    true = rng.normal(size=(k, d)).astype(np.float32)
    x = (true[rng.integers(0, k, 1024)] + 0.1 * rng.normal(size=(1024, d))).astype(np.float32)
    centers = (true + 0.01 * rng.normal(size=(k, d))).astype(np.float32)
    return x, centers


@pytest.mark.parametrize("n", [1024, 1000])
def test_tc_plain_matches_jax_interpret(n):
    """At tests/test_torch_kmeans.py:26-47's tolerances: centering and the
    three TF32 products compute the JAX kernel's function."""
    x, centers = _clustered()
    mask = np.ones(1024, bool)
    mask[n - 24:] = False
    ws, wc, wi, wb = jpk.lloyd_stats(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(centers),
                                     tile_n=256, interpret=True)
    s, c, i, b, lab = tpk.lloyd_stats_tc_plain(torch.as_tensor(x[:n]), torch.as_tensor(mask[:n]),
                                               torch.as_tensor(centers))
    np.testing.assert_array_equal(c.numpy(), np.asarray(wc))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(i), float(wi), rtol=1e-5)
    assert float(c.sum()) == n - 24
    assert b.shape == (n,) and (b.numpy()[n - 24:] == 0).all()
    np.testing.assert_allclose(b.numpy(), np.asarray(wb)[:n], rtol=1e-4, atol=1e-3)
    assert (lab.numpy()[n - 24:] == -1).all() and (lab.numpy()[:n - 24] >= 0).all()


def test_tf32_round_ties_away_from_zero():
    one_ulp, tie = 2.0 ** -10, 2.0 ** -11  # TF32 keeps 10 mantissa bits
    v = np.array([1.0, 1 + tie, -(1 + tie), 1 + tie - 2.0 ** -23, 1 + one_ulp,
                  -(1 + one_ulp), 1 + one_ulp + tie, 3.0 * 2.0 ** -130, 0.0, -0.0],
                 np.float32)
    want = np.array([1.0, 1 + one_ulp, -(1 + one_ulp), 1.0, 1 + one_ulp, -(1 + one_ulp),
                     1 + 2 * one_ulp, 3.0 * 2.0 ** -130, 0.0, -0.0], np.float32)
    got = tpk.tf32_round(torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the low 13 bits are clear, and hi + lo keeps the digits TF32 alone loses
    x = torch.as_tensor(np.random.default_rng(1).normal(size=4096).astype(np.float32))
    hi = tpk.tf32_round(x)
    lo = tpk.tf32_round(x - hi)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((hi - x) / x).abs().max()) <= 2.0 ** -11
    assert float(((hi + lo - x) / x).abs().max()) <= 2.0 ** -21
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    out = tpk.tf32_round(special)
    assert out[0] == float("inf") and out[1] == -float("inf") and torch.isnan(out[2])


def test_mean_over_valid_rows_only():
    """Masked rows set to huge values change nothing: mu, and so every
    centered distance, comes from the valid rows alone."""
    x, centers = _clustered()
    mask = np.ones(1024, bool)
    mask[-24:] = False
    far = x.copy()
    far[-24:] = 1e8
    far[-24::2] = -3e7
    args = (torch.as_tensor(mask), torch.as_tensor(centers))
    s0, c0, i0, b0, l0 = tpk.lloyd_stats_tc_plain(torch.as_tensor(x), *args)
    s1, c1, i1, b1, l1 = tpk.lloyd_stats_tc_plain(torch.as_tensor(far), *args)
    np.testing.assert_array_equal(l1.numpy(), l0.numpy())
    np.testing.assert_array_equal(c1.numpy(), c0.numpy())
    np.testing.assert_array_equal(s1.numpy(), s0.numpy())
    np.testing.assert_array_equal(b1.numpy(), b0.numpy())
    assert float(i1) == float(i0) and (l1.numpy()[-24:] == -1).all()


def _near_tie(seed, n=1024, d=256, k=16, sigma=0.005):
    """Points m + sigma * noise around one m = 0.5 |N(0, 1)|: |x|^2 ~ 80
    against a squared spread of d * sigma^2 ~ 6e-3, as ResNet features of
    near-equal patches; init k distinct rows."""
    rng = np.random.default_rng(seed)
    m = 0.5 * np.abs(rng.normal(size=d))
    x = (m + sigma * rng.normal(size=(n, d))).astype(np.float32)
    return x, x[rng.choice(n, k, replace=False)]


def _fit(stats, x, mask, init, tol, max_iter=300):
    """A Lloyd loop over one stats recipe (no empty cluster arises here):
    steps, and the final labels."""
    c, steps = init.clone(), 0
    while steps < max_iter:
        sums, counts = stats(x, mask, c)[:2]
        assert bool((counts > 0).all())
        new = sums / counts[:, None]
        shift, c, steps = float(((new - c) ** 2).sum()), new, steps + 1
        if shift <= tol:
            break
    out = stats(x, mask, c)
    return steps, out[4] if len(out) == 5 else torch.argmin(tpk._d2_plain(x, c), 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_near_tie_tc_recipe_follows_float64(seed):
    x, init = _near_tie(seed)
    mask = torch.ones(x.shape[0], dtype=torch.bool)
    xt, it = torch.as_tensor(x), torch.as_tensor(init)
    tol = 1e-4 * float(xt.double().var(0, unbiased=False).mean())
    steps64, lab64 = _fit(tpk.lloyd_stats_plain, xt.double(), mask, it.double(), tol)
    steps_tc, lab_tc = _fit(tpk.lloyd_stats_tc_plain, xt, mask, it, tol)
    steps32, lab32 = _fit(tpk.lloyd_stats_plain, xt, mask, it, tol)
    assert steps_tc == steps64
    np.testing.assert_array_equal(lab_tc.numpy(), lab64.numpy())
    # the fixture's reason to exist: uncentered f32 loses rows to rounding
    assert float((lab32 == lab64).float().mean()) < 0.95


@pytest.mark.parametrize("use_pallas", [False, True])
def test_kmeans_lloyd_matches_jax_with_trace(use_pallas):
    """``kmeans_lloyd(use_pallas=True)`` on CPU tensors (LloydPlan's plain
    route) still equals JAX, and ``_lloyd``'s trace records one (shift,
    empty) pair per step, the last one (False, False) when it converged."""
    rng = np.random.default_rng(1)
    cen = rng.normal(size=(10, 128))
    x = (cen[rng.integers(0, 10, 512)] + 0.5 * rng.normal(size=(512, 128))).astype(np.float32)
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
    xt, mt = torch.as_tensor(x), torch.as_tensor(mask)
    trace = []
    _, tl2, _, n_iter = tkm._lloyd(xt, mt, torch.as_tensor(init), 300,
                                   tkm._tol_abs(xt, mt, 1e-4), use_pallas, trace)
    assert n_iter == tn == len(trace) and trace[-1] == (False, False)
    np.testing.assert_array_equal(tl2.numpy(), tl.numpy())


def test_plan_cpu_route_is_the_plain_recipe():
    """On CPU tensors ``LloydPlan.stats`` is ``lloyd_stats_plain`` plus the
    labels (-1 on masked rows), and ``lloyd_stats`` keeps its contract."""
    x, centers = _clustered()
    mask = np.ones(1024, bool)
    mask[::7] = False
    xt, mt, ct = torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(centers)
    s, c, i, b, lab = tpk.LloydPlan(xt, mt).stats(ct)
    want = tpk.lloyd_stats_plain(xt, mt, ct)
    for got, ref in zip((s, c, i, b), want):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    for got, ref in zip(tpk.lloyd_stats(xt, mt, ct), want):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    d2 = tpk._d2_plain(xt, ct)
    np.testing.assert_array_equal(lab.numpy(), np.where(mask, d2.argmin(1).numpy(), -1))
    with pytest.raises(TypeError):
        tpk.LloydPlan(xt.double(), mt)
    with pytest.raises(ValueError):
        tpk.LloydPlan(xt, mt[:-1])


# ---------------------------------------------------------------------------
# more centers than one 128-wide tile (the kernel loops over center tiles)
# ---------------------------------------------------------------------------

def _clustered_k(k=200, n=512, d=64, seed=5):
    """n points around k centers (every center with members), init near them."""
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(k, d)).astype(np.float32)
    x = (true[np.arange(n) % k] + 0.05 * rng.normal(size=(n, d))).astype(np.float32)
    return x, (true + 0.01 * rng.normal(size=(k, d))).astype(np.float32)


def test_k200_plain_matches_jax_interpret_with_sentinels():
    """At k = 200 the JAX caller pads to 256 centers with 1e8 sentinels; the
    plain version of that call and the Pallas kernel in interpret mode give
    the same counts and sums, and the sentinels take no point."""
    x, centers = _clustered_k()
    mask = np.ones(len(x), bool)
    mask[-16:] = False
    cpad = np.concatenate([centers, np.full((56, centers.shape[1]), 1e8, np.float32)])
    ws, wc, wi, wb = jpk.lloyd_stats(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(cpad),
                                     tile_n=256, interpret=True)
    s, c, i, b = tpk.lloyd_stats_plain(torch.as_tensor(x), torch.as_tensor(mask),
                                       torch.as_tensor(cpad))
    np.testing.assert_array_equal(c.numpy(), np.asarray(wc))
    assert float(c[200:].sum()) == 0 and float(c.sum()) == len(x) - 16
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(i), float(wi), rtol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(wb), rtol=1e-4, atol=1e-3)
    # the kernel's recipe on the unpadded 200 centers: the same assignment
    s2, c2, i2, b2, lab = tpk.lloyd_stats_tc_plain(torch.as_tensor(x), torch.as_tensor(mask),
                                                   torch.as_tensor(centers))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(wc)[:200])
    np.testing.assert_allclose(s2.numpy(), np.asarray(ws)[:200], rtol=1e-5, atol=1e-4)


def test_k200_lloyd_matches_jax_pallas_interpret():
    """A Lloyd fit with 200 centers from one init: JAX's ``_lloyd`` through
    the Pallas kernel (interpret mode, sentinel-padded) and the port's K5
    mode on the CPU agree on labels, centers and steps; the port's
    ``kmeans_fit(n_clusters=200, use_pallas=True)`` runs and equals its plain
    backend there."""
    import jax

    x, init = _clustered_k(seed=6)
    mask = np.ones(len(x), bool)
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    xt, mt = torch.as_tensor(x), torch.as_tensor(mask)
    ttol = tkm._tol_abs(xt, mt, 1e-4)  # the same tol * mean(var) as kmeans_lloyd's
    jfit = jax.jit(lambda a, m, c: jkm._lloyd(a, m, c, 300, float(ttol), use_pallas=True,
                                               pallas_interpret=True))
    jc, jl, ji, jn = jfit(xj, mj, jnp.asarray(init))
    tc, tl, ti, tn = tkm._lloyd(xt, mt, torch.as_tensor(init), 300, ttol, True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    assert tn == int(jn)
    g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    k5 = tkm.kmeans_fit(xt, mt, g(), n_clusters=200, use_pallas=True)
    plain = tkm.kmeans_fit(xt, mt, g(), n_clusters=200, use_pallas=False)
    assert k5[0].shape == (200, 64) and bool(torch.isfinite(k5[0]).all())
    np.testing.assert_array_equal(k5[1].numpy(), plain[1].numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_k200_tc_recipe_labels_follow_float64(seed):
    """The kernel's recipe keeps the float64 first-index argmin over 200
    centers, across the 128-center tile boundary."""
    x, centers = _clustered_k(seed=10 + seed)
    x = x + 3.0  # far from the origin: the uncentered recipe's cancellation regime
    centers = centers + 3.0
    centers[150] = centers[20]  # an exact tie across the tile boundary: the first wins
    mask = torch.ones(len(x), dtype=torch.bool)
    xt, ct = torch.as_tensor(x), torch.as_tensor(centers)
    lab = tpk.lloyd_stats_tc_plain(xt, mask, ct)[4]
    d64 = ((xt.double()[:, None] - ct.double()[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(lab.numpy(), d64.argmin(1).numpy())
    assert int((lab == 150).sum()) == 0 and int((lab == 20).sum()) > 0
