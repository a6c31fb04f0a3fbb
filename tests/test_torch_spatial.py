"""Port pipeline/spatial.py against the JAX package on the CPU: the valid
tile grid and the qualifying windows equal to JAX's, the host window stage
per tile per gene within 1e-4 of JAX's (docs/PARITY_NOTES.md:151-158) for
ViS (per fold and stacked), ViT and HE2RNA folds, the device stage against
the host stage at JAX's rtol 2e-5 / atol 2e-6 (tests/test_spatial.py), zero
qualifying windows giving NaN tables, and the refusals."""

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from sequoia_tpu.models import he2rna as jhe
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.models import vit as jvit
from sequoia_tpu.pipeline import patch_gen as jpatch_gen
from sequoia_tpu.pipeline import spatial as jspatial
from sequoia_tpu_torch.models import convert, vis
from sequoia_tpu_torch.pipeline import spatial
from tests.test_pipeline_e2e import synthetic_wsi
from tests.test_spatial import make_grid_df

D, G = 16, 7
VIS = dict(num_outputs=G, input_dim=D, depth=1, nheads=2, dim_f=4, dim_s=4, dim_c=4,
           num_clusters=100)


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _vis_folds(n=2):
    cfg = jvis.ViSConfig(**VIS)
    jp = {f: jvis.init(cfg, jax.random.PRNGKey(f)) for f in range(n)}
    tp = {f: convert.vis_params_from_numpy(_np_tree(p)) for f, p in jp.items()}
    return cfg, jp, vis.ViSConfig(**VIS), tp


@pytest.fixture(scope="module")
def grid():
    rng = np.random.default_rng(5)
    df = make_grid_df(rng, nx=16, ny=16, keep=0.9)
    return df, rng.normal(size=(len(df), D)).astype(np.float32)


def test_build_valid_tiles_equals_jax():
    slide = synthetic_wsi()
    mask, _ = jpatch_gen.compute_slide_mask(slide)
    got = spatial.build_valid_tiles(mask, slide.dimensions, 64)
    want = jspatial.build_valid_tiles(mask, slide.dimensions, 64)
    assert len(got) > 30
    pd.testing.assert_frame_equal(got, want)
    # edge tiles whose mask crop is empty count as valid, as in the reference
    mask_xy = np.ones((10, 5), bool)
    got = spatial.build_valid_tiles(mask_xy, (35, 35), patch_size_resized=7)
    pd.testing.assert_frame_equal(got, jspatial.build_valid_tiles(mask_xy, (35, 35), 7))
    assert (got["ycoord"] >= 15).sum() > 0


@pytest.mark.parametrize("stride", [1, 3])
def test_collect_windows_equals_jax(grid, stride):
    df, _ = grid
    got = spatial.collect_windows(df, stride=stride)
    want = jspatial.collect_windows(df, stride=stride)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _assert_tables(got, want, tol=1e-4):
    (fk_g, m_g, seen_g), (fk_w, m_w, seen_w) = got, want
    assert fk_g == fk_w and (seen_g == seen_w).all() and seen_g.any()
    for f in fk_w:
        assert m_g[f].shape == m_w[f].shape
        np.testing.assert_array_equal(np.isnan(m_g[f]), np.isnan(m_w[f]))
        assert np.nanmax(np.abs(m_g[f] - m_w[f])) < tol


def test_host_windows_match_jax_per_fold_and_stacked(grid):
    df, feats = grid
    jcfg, jp, cfg, tp = _vis_folds()
    kw = dict(stride=2, batch_windows=7, accumulate="host")
    want = jspatial.sliding_window_predict_arrays(
        feats, df, {f: jspatial.make_vis_predict_fn(jcfg, p) for f, p in jp.items()},
        [0, 3, 6], **kw)
    per_fold = {f: spatial.make_vis_predict_fn(cfg, p) for f, p in tp.items()}
    _assert_tables(spatial.sliding_window_predict_arrays(feats, df, per_fold, [0, 3, 6], **kw),
                   want)
    stacked = spatial.make_vis_stacked_predict_fn(cfg, tp)
    assert stacked.fold_keys == [0, 1]
    _assert_tables(spatial.sliding_window_predict_arrays(feats, df, stacked, [0, 3, 6], **kw),
                   want)
    # the dict views
    a = spatial.sliding_window_predict_multi(feats, df, stacked, [0, 3], stride=3)
    b = jspatial.sliding_window_predict_multi(
        feats, df, jspatial.make_vis_stacked_predict_fn(jcfg, jp), [0, 3], stride=3)
    assert set(a) == set(b) == {0, 1}
    for f in a:
        for g in (0, 3):
            assert set(a[f][g]) == set(b[f][g])
            assert max(abs(a[f][g][k] - b[f][g][k]) for k in b[f][g]) < 1e-4
    one = spatial.sliding_window_predict(feats, df, per_fold[1], [2], stride=3)
    jone = jspatial.sliding_window_predict(feats, df, jspatial.make_vis_predict_fn(
        jcfg, jp[1]), [2], stride=3)
    assert set(one) == {2} and max(abs(one[2][k] - jone[2][k]) for k in jone[2]) < 1e-4


def test_vit_and_he2rna_windows_match_jax(grid):
    df, feats = grid
    feats = np.abs(feats)
    vcfg = jvit.ViTConfig(num_outputs=G, dim=D, depth=1, heads=2, dim_head=8, mlp_dim=12,
                          num_clusters=100)
    vp = jvit.init(vcfg, jax.random.PRNGKey(0))
    hcfg = jhe.HE2RNAConfig(input_dim=D, output_dim=G, layers=(10,), ks=(1, 2, 5, 10))
    hp = jhe.init(hcfg, jax.random.PRNGKey(1))
    from sequoia_tpu_torch.models import he2rna, vit

    tvcfg = vit.ViTConfig(num_outputs=G, dim=D, depth=1, heads=2, dim_head=8, mlp_dim=12,
                          num_clusters=100)
    thcfg = he2rna.HE2RNAConfig(input_dim=D, output_dim=G, layers=(10,), ks=(1, 2, 5, 10))
    import jax.numpy as jnp

    jfns = {0: lambda f: jvit.apply(vcfg, vp, jnp.asarray(f)),
            1: jspatial.make_he2rna_predict_fn(hcfg, hp)}
    tfns = {0: spatial.make_vit_predict_fn(tvcfg, convert.vit_params_from_numpy(_np_tree(vp))),
            1: spatial.make_he2rna_predict_fn(thcfg,
                                              convert.he2rna_params_from_numpy(_np_tree(hp)))}
    kw = dict(stride=2, batch_windows=9, accumulate="host")
    got = spatial.sliding_window_predict_arrays(feats, df, tfns, list(range(G)), **kw)
    want = jspatial.sliding_window_predict_arrays(feats, df, jfns, list(range(G)), **kw)
    _assert_tables(got, want)
    assert np.nanmin(got[1][1]) < 0  # no ReLU on the spatial path


def test_device_accumulate_matches_host(grid):
    """The device stage (one table upload, gathers, the stacked forward, the
    membership product into f32 sums) against the host's float64 sums:
    subset and identity gene selections, strides 1 and 3, partial tail
    chunks; at >= 1024 genes ``auto`` picks the device."""
    df, feats = grid
    _, _, cfg, tp = _vis_folds()
    stacked = spatial.make_vis_stacked_predict_fn(cfg, tp)
    for inds in ([0, 2, 5], list(range(G))):
        for stride in (1, 3):
            kw = dict(stride=stride, batch_windows=5)
            host = spatial.sliding_window_predict_arrays(feats, df, stacked, inds,
                                                         accumulate="host", **kw)
            dev = spatial.sliding_window_predict_arrays(feats, df, stacked, inds,
                                                        accumulate="device", **kw)
            assert host[0] == dev[0] and (host[2] == dev[2]).all()
            for f in host[0]:
                np.testing.assert_allclose(dev[1][f], host[1][f], rtol=2e-5, atol=2e-6)
    keys, sums, counts = spatial.sliding_window_predict_arrays(
        feats, df, stacked, [1, 4], accumulate="device", _device_sums=True)
    host = spatial.sliding_window_predict_arrays(feats, df, stacked, [1, 4], accumulate="host")
    seen = counts > 0
    for f in keys:
        assert isinstance(sums[f], torch.Tensor) and sums[f].shape == (len(df), 2)
        np.testing.assert_allclose(sums[f].numpy()[seen] / counts[seen, None],
                                   host[1][f][seen], rtol=2e-5, atol=2e-6)

    wide = vis.ViSConfig(**{**VIS, "num_outputs": 1024})
    wstacked = spatial.make_vis_stacked_predict_fn(
        wide, {0: vis.init(wide, torch.Generator().manual_seed(0))})
    calls = []
    real = spatial._sliding_window_device

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    spatial._sliding_window_device = spy
    try:
        spatial.sliding_window_predict_arrays(feats, df, wstacked, list(range(1024)),
                                              stride=5, batch_windows=16)
    finally:
        spatial._sliding_window_device = real
    assert calls == [1]


def test_zero_qualifying_windows_yield_nan_tables():
    df = pd.DataFrame({"xcoord": np.arange(5) * 10, "ycoord": np.zeros(5),
                       "xcoord_tf": np.arange(5), "ycoord_tf": np.zeros(5, int)})
    feats = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    fold_keys, means, seen = spatial.sliding_window_predict_arrays(
        feats, df, {0: lambda x: np.zeros((x.shape[0], 3)),
                    1: lambda x: np.zeros((x.shape[0], 3))}, gene_indices=[0, 2])
    assert fold_keys == [0, 1] and not seen.any()
    assert all(means[f].shape == (5, 2) and np.isnan(means[f]).all() for f in fold_keys)

    cfg = vis.ViSConfig(num_outputs=3, input_dim=8, depth=1, nheads=2, dim_f=4, dim_s=4,
                        dim_c=4, num_clusters=100)
    stacked = spatial.make_vis_stacked_predict_fn(
        cfg, {f: vis.init(cfg, torch.Generator().manual_seed(f)) for f in range(2)})
    for acc in ("host", "device"):
        fold_keys, means, _ = spatial.sliding_window_predict_arrays(
            feats, df, stacked, gene_indices=[1], accumulate=acc)
        assert fold_keys == [0, 1] and all(np.isnan(means[f]).all() for f in fold_keys)
    fold_keys, means, _ = spatial.sliding_window_predict_arrays(
        feats, df, lambda x: {0: np.zeros((x.shape[0], 3))}, gene_indices=[0])
    assert fold_keys == [] and means == {}


def test_accumulate_refusals(grid):
    df, feats = grid
    fns = {0: lambda x: np.zeros((x.shape[0], 3))}
    with pytest.raises(ValueError, match="stacked"):
        spatial.sliding_window_predict_arrays(feats, df, fns, [0], accumulate="device")
    with pytest.raises(ValueError, match="auto|host|device"):
        spatial.sliding_window_predict_arrays(feats, df, fns, [0], accumulate="gpu")
    with pytest.raises(ValueError, match="_device_sums"):
        spatial.sliding_window_predict_arrays(feats, df, fns, [0], _device_sums=True)
    # JAX's two mesh refusals (sequoia_tpu/pipeline/spatial.py:298-306)
    with pytest.raises(ValueError, match="stacked predictor"):
        spatial.sliding_window_predict_arrays(feats, df, fns, [0], mesh=object())
    stacked = lambda x: {0: np.zeros((x.shape[0], 3))}  # noqa: E731
    stacked.raw_fwd = lambda x: None
    with pytest.raises(ValueError, match="accumulate='device'"):
        spatial.sliding_window_predict_arrays(feats, df, stacked, [0], accumulate="host",
                                              mesh=object())
