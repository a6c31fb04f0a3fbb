"""The port's tissue screen (ops/masking.py) and coarse candidate grid
(pipeline/patch_gen.py) against the JAX package on the CPU, on the fixtures
of tests/test_masking.py and the synthetic slide of tests/test_pipeline_e2e.py:
thresholds, masks, flags and coordinates must be equal."""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from sequoia_tpu.ops import masking as jm
from sequoia_tpu.pipeline import patch_gen as jpg
from sequoia_tpu_torch.data.wsi import ArrayReader
from sequoia_tpu_torch.ops import masking as tm
from sequoia_tpu_torch.pipeline import patch_gen as tpg
from tests.test_masking import np_otsu
from tests.test_pipeline_e2e import synthetic_wsi


def _fixtures_float():
    rng = np.random.default_rng(0)
    bimodal = np.r_[rng.normal(50, 5, 600), rng.normal(180, 12, 400)].astype(np.float32)
    rng = np.random.default_rng(1)
    batch = np.stack([np.r_[rng.normal(30, 3, 100), rng.normal(200, 10, 100)],
                      np.r_[rng.normal(90, 6, 100), rng.normal(140, 4, 100)]]
                     ).astype(np.float32)
    return [bimodal, batch, np.full(50, 0.25, np.float32)]


def _fixtures_u8():
    rng = np.random.default_rng(4)
    out = [np.concatenate([rng.integers(10, 90, 700), rng.integers(140, 250, 500)]
                          ).astype(np.uint8) for _ in range(5)]
    out.append(np.full(30, 77, np.uint8))  # constant: returns the value
    return out


@pytest.mark.parametrize("i", range(3))
def test_otsu_float_matches_jax(i):
    v = _fixtures_float()[i]
    want = np.asarray(jm.otsu_threshold(jnp.asarray(v)))
    got = tm.otsu_threshold(torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(got, want)
    for row, thr in zip(v.reshape(-1, v.shape[-1]), np.atleast_1d(got)):
        if np.ptp(row) > 0:
            assert np.array_equal(row > thr, row > np_otsu(row))


@pytest.mark.parametrize("i", range(6))
def test_otsu_uint8_matches_jax(i):
    v = _fixtures_u8()[i]
    want = float(jm.otsu_threshold(jnp.asarray(v)))
    got = float(tm.otsu_threshold(torch.as_tensor(v)))
    assert got == want and got.is_integer()
    if np.ptp(v) > 0:
        assert got == float(np_otsu(v))


def test_saturation_and_gray_match_jax():
    img = np.random.default_rng(2).integers(0, 256, size=(5, 4, 3), dtype=np.uint8)
    img[0, 0] = 0  # max == 0: saturation 0
    np.testing.assert_array_equal(tm.rgb_to_saturation(torch.as_tensor(img)).numpy(),
                                  np.asarray(jm.rgb_to_saturation(jnp.asarray(img))))
    np.testing.assert_allclose(tm.rgb_to_gray(torch.as_tensor(img)).numpy(),
                               np.asarray(jm.rgb_to_gray(jnp.asarray(img))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("it", [1, 3])
def test_morphology_matches_scipy_and_jax(it):
    m = np.random.default_rng(3).random((40, 33)) > 0.7
    d = tm.binary_dilation(torch.as_tensor(m), iterations=it).numpy()
    e = tm.binary_erosion(torch.as_tensor(m), iterations=it).numpy()
    np.testing.assert_array_equal(d, ndimage.binary_dilation(m, iterations=it))
    np.testing.assert_array_equal(e, ndimage.binary_erosion(m, iterations=it))
    np.testing.assert_array_equal(d, np.asarray(jm.binary_dilation(jnp.asarray(m), it)))
    # batched over a leading axis: each slice as on its own
    mb = np.stack([m, ~m])
    db = tm.binary_dilation(torch.as_tensor(mb), iterations=it).numpy()
    np.testing.assert_array_equal(db[1], ndimage.binary_dilation(~m, iterations=it))


def test_tissue_mask_matches_jax():
    img = np.full((32, 32, 3), 245, np.uint8)
    img[8:24, 8:24] = (150, 60, 120)
    tex = np.random.default_rng(6).integers(0, 256, size=(48, 40, 3), dtype=np.uint8)
    for im in (img, tex):
        want = np.asarray(jm.tissue_mask(jnp.asarray(im)))
        got = tm.tissue_mask(torch.as_tensor(im)).numpy()
        np.testing.assert_array_equal(got, want)
    got = tm.tissue_mask(torch.as_tensor(img)).numpy()
    assert got[10:22, 10:22].all() and not got[:4].any() and not got[:, :4].any()


def test_low_contrast_matches_jax():
    flat = np.full((16, 16, 3), 128, np.uint8)
    noisy = np.random.default_rng(4).integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    got = tm.is_low_contrast(torch.as_tensor(np.stack([flat, noisy]))).numpy()
    assert got.tolist() == [bool(jm.is_low_contrast(jnp.asarray(flat))),
                            bool(jm.is_low_contrast(jnp.asarray(noisy)))] == [True, False]


def test_patch_keep_flags_match_jax():
    rng = np.random.default_rng(5)
    p = np.zeros((8, 32, 32, 3), np.uint8)
    p[0] = 245  # blank background
    p[1] = rng.integers(40, 230, size=(32, 32, 3))  # textured
    p[2, ..., 0] = rng.integers(150, 220, (32, 32))  # pink tissue
    p[2, ..., 1] = rng.integers(60, 140, (32, 32))
    p[2, ..., 2] = rng.integers(150, 230, (32, 32))
    p[3] = p[2]
    p[3, :24] = 242  # tissue on a quarter, background above
    p[4] = 128  # flat grey: low contrast
    p[5] = rng.integers(0, 256, size=(32, 32, 3))
    p[6, ::2] = p[2, ::2]  # striped tissue
    # p[7] stays black (the consumer's zero padding)
    want = np.asarray(jm.patch_keep_flags(jnp.asarray(p)))
    got = tm.patch_keep_flags(torch.as_tensor(p)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2] and not got[0] and not got[4] and not got[7]


def _port_reader(jslide):
    return ArrayReader([lv.copy() for lv in jslide.levels], properties=dict(jslide.properties))


@pytest.mark.parametrize("seed", [0, 1])
def test_slide_mask_and_candidates_match_jax(seed):
    jslide = synthetic_wsi(seed=seed)
    tslide = _port_reader(jslide)
    jmask, jlevel = jpg.compute_slide_mask(jslide)
    tmask, tlevel = tpg.compute_slide_mask(tslide, device="cpu")
    assert tlevel == jlevel == 1
    np.testing.assert_array_equal(tmask, jmask)
    assert tmask.shape == (512, 384)  # [x, y] layout of level 1
    for ps in (64, 256):
        want = jpg.masked_candidates(jslide, jmask, jlevel, ps)
        got = tpg.masked_candidates(tslide, tmask, tlevel, ps)
        assert got == want
        assert len(got[0]) > 10
    assert tpg.candidate_grid(300, 200, 64) == jpg.candidate_grid(300, 200, 64)


def test_resize_factor_follows_appmag():
    for props, rf in (({"aperio.AppMag": "40"}, 2.0), ({}, 1.0), ({"aperio.AppMag": ""}, 1.0)):
        slide = ArrayReader([np.zeros((8, 8, 3), np.uint8)], properties=props)
        assert tpg.resize_factor(slide) == jpg.resize_factor(slide) == rf
