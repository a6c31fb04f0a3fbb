"""The port's Pillow-exact resize (``sequoia_tpu_torch/ops/pil_resize.py``)
against Pillow itself and against the JAX package's ``resize_u8``, bit for
bit, at tests/test_pil_resize.py's cases, plus the identity and the
coefficient rows."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from sequoia_tpu.ops import pil_resize as jpr
from sequoia_tpu_torch.ops import pil_resize as tpr


def _pil_resize(u8: np.ndarray, out_hw, filt) -> np.ndarray:
    resample = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}[filt]
    return np.stack([np.asarray(Image.fromarray(img).resize(
        (out_hw[1], out_hw[0]), resample=resample)) for img in u8])


@pytest.mark.parametrize("in_hw,out_hw,filt", [
    ((256, 256), (224, 224), "bilinear"),  # the UNI patch contract
    ((300, 280), (224, 224), "bilinear"),  # non-square downscale
    ((100, 100), (224, 224), "bilinear"),  # upscale
    ((256, 256), (224, 224), "bicubic"),   # negative taps
    ((64, 128), (96, 40), "bicubic"),      # up on one axis, down on the other
])
def test_matches_pillow_and_jax(in_hw, out_hw, filt):
    u8 = np.random.default_rng(0).integers(0, 256, size=(4, *in_hw, 3), dtype=np.uint8)
    got = tpr.resize_u8(torch.as_tensor(u8), out_hw[0], out_hw[1], filt)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (4, *out_hw, 3)
    np.testing.assert_array_equal(got.numpy(), _pil_resize(u8, out_hw, filt))
    want = np.asarray(jpr.resize_u8(jnp.asarray(u8), out_hw[0], out_hw[1], filt))
    np.testing.assert_array_equal(got.numpy(), want)


def test_identity_when_same_size():
    u8 = np.random.default_rng(1).integers(0, 256, size=(2, 64, 64, 3), dtype=np.uint8)
    got = tpr.resize_u8(torch.as_tensor(u8), 64, 64)
    np.testing.assert_array_equal(got.numpy(), u8)
    with pytest.raises(TypeError, match="uint8"):
        tpr.resize_u8(torch.as_tensor(u8).float(), 32, 32)


def test_leading_axes_and_one_axis():
    """Any leading axes, and a resize along one axis only."""
    u8 = np.random.default_rng(2).integers(0, 256, size=(2, 3, 40, 50, 3), dtype=np.uint8)
    got = tpr.resize_u8(torch.as_tensor(u8), 40, 30).numpy()
    want = _pil_resize(u8.reshape(6, 40, 50, 3), (40, 30), "bilinear").reshape(2, 3, 40, 30, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_size,out_size,filt", [(256, 224, "bilinear"), (100, 224, "bilinear"),
                                                   (256, 224, "bicubic")])
def test_coeff_rows(in_size, out_size, filt):
    """The coefficient matrix is JAX's, rows sum to ~2**22, the taps are
    banded (at most 4 for bilinear at 8/7), and the gather form holds every
    nonzero coefficient once."""
    m = tpr.pil_coeff_matrix(in_size, out_size, filt)
    np.testing.assert_array_equal(m, jpr.pil_coeff_matrix(in_size, out_size, filt))
    np.testing.assert_allclose(m.sum(axis=1), 1 << 22, atol=4)
    if filt == "bilinear" and in_size > out_size:
        assert (m != 0).sum(axis=1).max() <= 4
    idx, coef = tpr._taps(in_size, out_size, filt)
    dense = np.zeros_like(m, dtype=np.int64)
    np.add.at(dense, (np.arange(out_size)[:, None].repeat(idx.shape[1], 1), idx), coef)
    np.testing.assert_array_equal(dense, m)
