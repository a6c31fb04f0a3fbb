"""The port's raw-YCbCr reconstruction (``sequoia_tpu_torch/ops/ycbcr.py``)
against the JAX package's: bit-exact against its numpy twin and its jitted
``jnp`` form on random planes, against a scalar transcription of libjpeg's
``jdsample.c`` h2v1 filter (tests/test_ycbcr.py's), and against the port's
native reader's own RGB decode of JPEG tiles."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.ops import ycbcr as jycbcr
from sequoia_tpu_torch import native
from sequoia_tpu_torch.ops import ycbcr

T = 64  # tile side (a multiple of 16 for JPEG MCUs)
SUBS = [(2, 2), (2, 1), (1, 1)]


def _planes(rng, n, h, w, sub):
    ny, nc = ycbcr.planar_sizes(h, w, *sub)
    return rng.integers(0, 256, (n, ny + 2 * nc), dtype=np.uint8)


@pytest.mark.parametrize("sub", SUBS)
def test_planar_to_rgb_bit_exact_vs_jax(sub):
    rng = np.random.default_rng(3)
    # a rectangular region: rows and columns upsample separately
    buf = _planes(rng, 5, T, T // 2, sub)
    want = jycbcr.planar_to_rgb(buf, T, T // 2, *sub)
    jitted = jax.jit(lambda b: jycbcr.planar_to_rgb(b, T, T // 2, *sub))(jnp.asarray(buf))
    got = ycbcr.planar_to_rgb(torch.from_numpy(buf), T, T // 2, *sub)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (5, T, T // 2, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jitted))


def test_mask_to_valid_matches_jax():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    wh = np.array([[16, 16], [5, 16], [16, 3], [0, 0]], np.int32)
    got = ycbcr.mask_to_valid(torch.from_numpy(rgb), torch.from_numpy(wh))
    np.testing.assert_array_equal(got.numpy(), jycbcr.mask_to_valid(rgb, wh))
    assert not got[3].any()


def test_h2v1_fancy_matches_libjpeg_scalar_transcription():
    rng = np.random.default_rng(4)
    p = rng.integers(0, 256, (2, 7, 9), dtype=np.int64).astype(np.int32)

    def scalar_h2v1(row):
        w = len(row)
        out = np.empty(2 * w, np.int32)
        out[0] = row[0]
        out[1] = (row[0] * 3 + row[1] + 2) >> 2
        for k in range(1, w - 1):
            out[2 * k] = (row[k] * 3 + row[k - 1] + 1) >> 2
            out[2 * k + 1] = (row[k] * 3 + row[k + 1] + 2) >> 2
        out[2 * w - 2] = (row[w - 1] * 3 + row[w - 2] + 1) >> 2
        out[2 * w - 1] = row[w - 1]
        return out

    want = np.stack([np.stack([scalar_h2v1(r) for r in im]) for im in p])
    np.testing.assert_array_equal(ycbcr.fancy_upsample_h2v1(torch.from_numpy(p)).numpy(), want)
    np.testing.assert_array_equal(
        ycbcr.fancy_upsample_h2v2(torch.from_numpy(p)).numpy(), jycbcr.fancy_upsample_h2v2(p))


def test_unsupported_subsampling_raises():
    buf = torch.zeros((1, T * T + 2 * (T // 2) * T), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unsupported subsampling"):
        ycbcr.planar_to_rgb(buf, T, T, 1, 2)


@pytest.mark.skipif(not native.available(), reason="the port's native reader did not build")
@pytest.mark.parametrize("sub", SUBS)
def test_bit_exact_vs_native_rgb_decode(tmp_path, sub):
    """(2, 2) and (1, 1) decode through libtiff's raw mode, (2, 1) through
    the libjpeg-direct tile decode; each rebuilds to the RGB decode."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (3 * T, 3 * T, 3), dtype=np.uint8)
    path = str(tmp_path / "s.tiff")
    native.write_tiled_tiff(path, [img], tile=(T, T), jpeg_quality=80, subsampling=sub)
    r = native.NativeTiffReader(path)
    assert r.ycbcr_subsampling(0, (T, T)) == sub
    coords = [(x * T, y * T) for x in range(3) for y in range(3)]
    rgb = r.read_regions(coords, 0, (T, T))
    raw = r.read_regions_ycbcr(coords, 0, (T, T))
    np.testing.assert_array_equal(ycbcr.planar_to_rgb(torch.from_numpy(raw), T, T, *sub).numpy(),
                                  rgb)
    r.close()
