"""Port ops/nn.py against sequoia_tpu.ops.nn, in f32 and bf16, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequoia_tpu.ops import nn as jnn
from sequoia_tpu_torch.ops import nn as tnn

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: different summation order only; bf16: one output rounding (2^-8 relative)
# plus JAX-on-CPU's bf16 accumulation of the dot
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(a: np.ndarray, name: str):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a).astype(jdt), torch.as_tensor(a).to(tdt)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("dt", DTYPES)
def test_gelu(dt):
    a = np.random.default_rng(0).normal(size=(64, 33)).astype(np.float32) * 3
    xj, xt = _pair(a, dt)
    np.testing.assert_allclose(_np(tnn.gelu(xt)), _np(jnn.gelu(xj)), **TOL[dt])


@pytest.mark.parametrize("dt", DTYPES)
def test_layer_norm_per_head(dt):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 5, 4, 16)).astype(np.float32) * 2 + 1
    scale = rng.normal(size=(4, 16)).astype(np.float32)
    bias = rng.normal(size=(4, 16)).astype(np.float32)
    xj, xt = _pair(a, dt)
    got = tnn.layer_norm(xt, torch.as_tensor(scale), torch.as_tensor(bias))
    want = jnn.layer_norm(xj, jnp.asarray(scale), jnp.asarray(bias))
    assert got.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


@pytest.mark.parametrize("dt", DTYPES)
def test_linear(dt):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 7, 96)).astype(np.float32)
    w = (rng.normal(size=(96, 40)) / 10).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    xj, xt = _pair(a, dt)
    got = tnn.linear(xt, torch.as_tensor(w), torch.as_tensor(b))
    want = jnn.linear(xj, jnp.asarray(w), jnp.asarray(b))
    assert got.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


@pytest.mark.parametrize("dt", DTYPES)
def test_einsum_per_head_combine(dt):
    rng = np.random.default_rng(3)
    cat = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    wc = (rng.normal(size=(4, 16, 8)) / 4).astype(np.float32)
    xj, xt = _pair(cat, dt)
    got = tnn.einsum("bnhi,hio->bnho", xt, torch.as_tensor(wc))
    want = jnn.einsum("bnhi,hio->bnho", xj, jnp.asarray(wc))
    assert got.dtype == torch.float32  # f32 accumulation, f32 result
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


def test_slice_linear_outputs_checks_bounds():
    w, b = torch.arange(12.0).reshape(3, 4), torch.arange(4.0)
    w2, b2, n = tnn.slice_linear_outputs(w, b, [3, 1], 4)
    assert n == 2 and b2.tolist() == [3.0, 1.0] and w2[:, 0].tolist() == [3.0, 7.0, 11.0]
    for bad in ([4], [-1], []):
        with pytest.raises(ValueError):
            tnn.slice_linear_outputs(w, b, bad, 4)


def test_precision_sets_ieee_f32_and_names_dtypes():
    torch.backends.cudnn.allow_tf32 = True
    assert tnn.precision("bfloat16") == torch.bfloat16
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert tnn.precision(None) == torch.float32
    with pytest.raises(ValueError):
        tnn.compute_dtype("float16")
