"""Port K4 ``bottleneck_chain`` (ops/cuda_resnet.py) against the JAX package
on the CPU: the plain (P, C) chain against the Pallas kernel in interpret
mode, and the ``fused_stages`` / ``cp_stages`` wiring of models/resnet.py
against the port's plain path (tests/test_torch_resnet_stages.py holds the
whole extractor against JAX)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.ops import pallas_resnet as jpr
from sequoia_tpu_torch import _build
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.models import resnet as tresnet
from sequoia_tpu_torch.ops import cuda_resnet as tpr
from tests.test_torch_resnet import small_params


def _carry(jparams):
    return convert.resnet_params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("H,W", [(8, 8), (8, 16)])
def test_chain_plain_matches_jax_interpret(H, W):
    jblocks = small_params(jax.random.PRNGKey(0))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, H * W, 8)))
    flat, meta = jpr.stage_chain_weights(jblocks, 0, jnp.float32)
    want = np.asarray(jpr.bottleneck_chain(jnp.asarray(x), flat, meta=meta, H=H, W=W,
                                           row_chunk=H * W, interpret=True))
    tflat, tmeta = tpr.stage_chain_weights(_carry(jblocks), 0, torch.float32)
    assert tmeta == meta
    for a, b in zip(tflat, flat):  # the folded weights carry across exactly
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    before = dict(_build.LAUNCHES)
    got = tpr.bottleneck_chain(torch.as_tensor(x), tflat, meta=tmeta, H=H, W=W,
                               row_chunk=H * W)
    assert _build.LAUNCHES == before  # a CPU tensor runs the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_chain_row_chunking_matches_unchunked():
    jblocks = small_params(jax.random.PRNGKey(2))
    H = W = 8
    x = np.array(jax.random.normal(jax.random.PRNGKey(3), (1, H * W, 8)))
    tflat, meta = tpr.stage_chain_weights(_carry(jblocks), 0, torch.float32)
    xt = torch.as_tensor(x)
    full = tpr.bottleneck_chain(xt, tflat, meta=meta, H=H, W=W, row_chunk=H * W)
    chunked = tpr.bottleneck_chain(xt, tflat, meta=meta, H=H, W=W, row_chunk=2 * W)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=1e-6, atol=1e-6)
    # and the JAX kernel's chunked run agrees with both
    flat, _ = jpr.stage_chain_weights(jblocks, 0, jnp.float32)
    jchunked = jpr.bottleneck_chain(jnp.asarray(x), flat, meta=meta, H=H, W=W,
                                    row_chunk=2 * W, interpret=True)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(jchunked), rtol=1e-5, atol=1e-5)


def test_chain_matches_cp_layout_chain():
    """K4 (P, C) and K3 (C, P) compute the same blocks."""
    blocks = _carry(small_params(jax.random.PRNGKey(4)))
    H, W = 4, 8
    x = torch.randn((2, 8, H * W), generator=torch.Generator().manual_seed(0))
    flat, meta = tpr.stage_chain_weights(blocks, 0, torch.float32)
    cflat, _ = tpr.stage_chain_weights_cp(blocks, 0, torch.float32)
    pc = tpr.bottleneck_chain(x.transpose(1, 2).contiguous(), flat, meta=meta, H=H, W=W)
    cp = tpr.bottleneck_chain_cp(x, cflat, meta=meta, H=H, W=W)
    torch.testing.assert_close(pc.transpose(1, 2), cp, rtol=1e-5, atol=1e-5)


def test_chain_rejects_what_jax_asserts():
    blocks = _carry(small_params(jax.random.PRNGKey(5)))
    flat, meta = tpr.stage_chain_weights(blocks, 0, torch.float32)
    x = torch.zeros((1, 64, 8))
    with pytest.raises(ValueError, match="H\\*W"):
        tpr.bottleneck_chain(x, flat, meta=meta, H=8, W=4)
    with pytest.raises(ValueError, match="row_chunk"):
        tpr.bottleneck_chain(x, flat, meta=meta, H=8, W=8, row_chunk=24)
    with pytest.raises(ValueError, match="row_chunk"):
        tpr.bottleneck_chain(x, flat, meta=meta, H=8, W=8, row_chunk=12)
    mixed = meta[:1] + ((meta[1][0], meta[1][1] * 2, meta[1][2], False),)
    with pytest.raises(ValueError, match="uniform width"):
        tpr.bottleneck_chain(x, flat, meta=mixed, H=8, W=8)
    with pytest.raises(ValueError, match="channels"):
        tpr.bottleneck_chain(torch.zeros((1, 64, 4)), flat, meta=meta, H=8, W=8)


@pytest.mark.parametrize("opts", [dict(fused_stages=(1, 2, 3, 4)),
                                  dict(early_pallas=True, cp_stages=(2, 3, 4)),
                                  dict(early_pallas=True, fused_stages=(1, 3),
                                       cp_stages=(2, 3))],
                         ids=["fused_stages", "early_cp_stages", "mixed"])
def test_stage_options_match_plain_path_bf16(opts):
    tp = tresnet.random_params(torch.Generator().manual_seed(0))
    imgs = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    base = tresnet.extract_from_uint8(tresnet.ResNetConfig(compute_dtype=torch.bfloat16),
                                      tp, imgs)
    got = tresnet.extract_from_uint8(
        tresnet.ResNetConfig(compute_dtype=torch.bfloat16, **opts), tp, imgs)
    assert got.dtype == torch.float32
    rel = (got - base).abs().max() / base.abs().max()
    assert float(rel) < 5e-2  # bf16 rounds at other places in the two paths


def test_fused_chain_row_chunk_rule():
    """_fused_chain picks whole rows, at most 512 pixels (bf16) / 256 (f32),
    dividing H*W, as the JAX caller does."""
    seen = []
    orig = tpr.bottleneck_chain

    def spy(x, flat, *, meta, H, W, row_chunk=512):
        seen.append((x.dtype, H, W, row_chunk))
        assert x.is_contiguous()  # channels_last: the (B, H*W, C) view is free
        return orig(x, flat, meta=meta, H=H, W=W, row_chunk=row_chunk)

    tp = tresnet.random_params(torch.Generator().manual_seed(2))
    x = torch.randn((1, 96, 96, 3), generator=torch.Generator().manual_seed(3))
    try:
        tpr.bottleneck_chain = spy
        for dt in (torch.float32, torch.bfloat16):
            tresnet.forward_extract(tresnet.ResNetConfig(compute_dtype=dt,
                                                         fused_stages=(1, 2)), tp, x)
    finally:
        tpr.bottleneck_chain = orig
    # layer1 map 24x24, layer2 12x12
    assert seen == [(torch.float32, 24, 24, 192), (torch.float32, 12, 12, 144),
                    (torch.bfloat16, 24, 24, 288), (torch.bfloat16, 12, 12, 144)]
