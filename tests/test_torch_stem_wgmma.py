"""The tensor-core routes of K2 (ops/cuda_resnet.py ``stem16``,
csrc/stem_wgmma.cu) on the CPU: the wrapper's routing and checks against a
stand-in for the kernel library, and the plain version of the kernel's tile
walk against the JAX Pallas stem in interpret mode and the port's plain
stem."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.models import resnet as jresnet
from sequoia_tpu.ops import pallas_resnet as jpr
from sequoia_tpu_torch import _build
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.ops import cuda_resnet as tpr
from tests.test_torch_vis_wgmma import fake_lib  # noqa: F401  (fixture)


def _x16(B, H2, W2, seed):
    """Row-padded space-to-depth input, as tests/test_torch_resnet.py builds it."""
    x = np.random.default_rng(seed).normal(size=(B, 2 * H2, 2 * W2, 3)).astype(np.float32)
    xs = x.reshape(B, H2, 2, W2, 2, 3).transpose(0, 2, 4, 5, 1, 3)
    x16 = np.pad(xs.reshape(B, 12, H2, W2), ((0, 0), (0, 4), (2, 1), (0, 0)))
    return x16.reshape(B, 16, (H2 + 3) * W2)


@pytest.fixture(scope="module")
def weights():
    jp = jresnet.random_params(jax.random.PRNGKey(0))
    tp = convert.resnet_params_from_numpy(jax.tree.map(np.asarray, jp))
    return jp, tp


# H2 = W2 = 16 (two whole tiles), a ragged map with H2 != W2 (240 pixels: the
# last tile 112 wide), and B = 3 with one 128-pixel tile per image
SHAPES = [(2, 16, 16), (2, 10, 24), (3, 8, 16)]


@pytest.mark.parametrize("B,H2,W2", SHAPES, ids=["16x16", "10x24", "b3"])
def test_tiles_plain_matches_jax_interpret_f32(weights, B, H2, W2):
    jp, tp = weights
    x16 = _x16(B, H2, W2, seed=H2 * W2 + B)
    a, bias = jpr.fold_stem16_weights(jp["conv1_s2d"], jp["bn1"], jnp.float32)
    want = np.asarray(jpr.stem16(jnp.asarray(x16), a, bias, H2=H2, W2=W2, interpret=True))
    ta, tbias = tpr.fold_stem16_weights(tp["conv1_s2d"], tp["bn1"], torch.float32)
    x = torch.as_tensor(x16)
    got = tpr.stem16_tiles_plain(x, ta, tbias, H2=H2, W2=W2)
    assert got.shape == (B, 64, H2 * W2)
    # tests/test_torch_resnet.py:79
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), tpr.stem16_plain(x, ta, tbias, H2=H2, W2=W2).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H2,W2", SHAPES, ids=["16x16", "10x24", "b3"])
def test_tiles_plain_matches_jax_interpret_bf16(weights, B, H2, W2):
    jp, tp = weights
    x16 = _x16(B, H2, W2, seed=B + H2)
    a, bias = jpr.fold_stem16_weights(jp["conv1_s2d"], jp["bn1"], jnp.bfloat16)
    want = np.asarray(jpr.stem16(jnp.asarray(x16, jnp.bfloat16), a, bias, H2=H2, W2=W2,
                                 interpret=True)).astype(np.float32)
    ta, tbias = tpr.fold_stem16_weights(tp["conv1_s2d"], tp["bn1"], torch.bfloat16)
    x = torch.as_tensor(x16).to(torch.bfloat16)
    got = tpr.stem16_tiles_plain(x, ta, tbias, H2=H2, W2=W2)
    assert got.dtype == torch.bfloat16
    # the same products and one rounding: equal to the port's plain stem, and
    # within a bf16 rounding step of JAX's (which sums in another order)
    torch.testing.assert_close(got, tpr.stem16_plain(x, ta, tbias, H2=H2, W2=W2), rtol=0, atol=0)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


def test_tiles_plain_needs_whole_chunks(weights):
    _, tp = weights
    ta, tbias = tpr.fold_stem16_weights(tp["conv1_s2d"], tp["bn1"], torch.float32)
    with pytest.raises(ValueError, match="W2 % 8"):
        tpr.stem16_tiles_plain(torch.zeros((1, 16, 11 * 12)), ta, tbias, H2=8, W2=12)


# ---------------------------------------------------------------------------
# the wrapper: which kernel, what it refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "sq_stem_wgmma"),
                                         (torch.float32, "sq_stem_tf32")], ids=["bf16", "f32"])
def test_cuda_route_picks_the_kernel(fake_lib, weights, dtype, entry):  # noqa: F811
    _, tp = weights
    ta, tbias = tpr.fold_stem16_weights(tp["conv1_s2d"], tp["bn1"], dtype)
    x = torch.as_tensor(_x16(2, 10, 24, 0)).to(dtype)
    out = tpr._stem16_cuda(x, ta, tbias, H2=10, W2=24)
    assert out.shape == (2, 64, 240) and out.dtype == dtype
    [(name, args)] = fake_lib.calls
    assert name == entry and len(args) == len(_build._SIGNATURES[entry])
    assert args[4:7] == (2, 10, 24)  # B, H2, W2
    assert _build.LAUNCHES["stem16"] == 1


def test_bf16_route_refuses_what_the_kernel_does_not_take(fake_lib, weights):  # noqa: F811
    _, tp = weights
    ta, tbias = tpr.fold_stem16_weights(tp["conv1_s2d"], tp["bn1"], torch.bfloat16)
    with pytest.raises(ValueError, match="W2 % 8"):  # JAX's W2 % 128 is a TPU rule only
        tpr._stem16_cuda(torch.zeros((1, 16, 11 * 12), dtype=torch.bfloat16), ta, tbias,
                         H2=8, W2=12)
    nc = torch.zeros((1, 11 * 16, 16), dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tpr._stem16_cuda(nc, ta, tbias, H2=8, W2=16)
    unaligned = torch.zeros(16 * 11 * 16 + 1, dtype=torch.bfloat16)[1:].view(1, 16, 176)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpr._stem16_cuda(unaligned, ta, tbias, H2=8, W2=16)
    with pytest.raises(TypeError, match="bf16"):
        tpr._stem_wgmma_check(torch.zeros((1, 16, 176)), ta, tbias.reshape(-1), W2=16)
    assert fake_lib.calls == [] and _build.LAUNCHES["stem16"] == 0


def test_cpu_tensors_run_the_plain_version(fake_lib, weights):  # noqa: F811
    _, tp = weights
    ta, tbias = tpr.fold_stem16_weights(tp["conv1_s2d"], tp["bn1"], torch.bfloat16)
    x = torch.as_tensor(_x16(1, 8, 16, 1)).to(torch.bfloat16)
    out = tpr.stem16(x, ta, tbias, H2=8, W2=16)
    assert fake_lib.calls == [] and _build.LAUNCHES["stem16"] == 0
    torch.testing.assert_close(out, tpr.stem16_plain(x, ta, tbias, H2=8, W2=16), rtol=0, atol=0)
