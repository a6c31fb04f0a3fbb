"""Port ResNet-50 (models/resnet.py, ops/cuda_resnet.py) against the JAX
package on the CPU: the K2/K3 plain versions against the Pallas kernels in
interpret mode, the full extractor with and without ``early_pallas``, and the
torchvision state-dict loader."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.models import resnet as jresnet
from sequoia_tpu.ops import pallas_resnet as jpr
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.models import resnet as tresnet
from sequoia_tpu_torch.ops import cuda_resnet as tpr
from tests.torch_goldens import resnet50_sd


def _carry(jparams):
    return convert.resnet_params_from_numpy(jax.tree.map(np.asarray, jparams))


def small_params(key, widths=(8,), cin0=8, nblocks=2):
    """A tiny bottleneck stage with non-trivial folded BN (JAX layout)."""
    def conv(key, kh, kw, ci, co):
        return jax.random.normal(key, (kh, kw, ci, co)) * np.sqrt(2.0 / (kh * kw * ci))

    def bn(key, c):
        k1, k2 = jax.random.split(key)
        return {"scale": 1.0 + 0.1 * jax.random.normal(k1, (c,)),
                "bias": 0.1 * jax.random.normal(k2, (c,))}

    keys = iter(jax.random.split(key, 64))
    w, cin, layer = widths[0], cin0, []
    for b in range(nblocks):
        blk = {"conv1": conv(next(keys), 1, 1, cin, w), "bn1": bn(next(keys), w),
               "conv2": conv(next(keys), 3, 3, w, w), "bn2": bn(next(keys), w),
               "conv3": conv(next(keys), 1, 1, w, 4 * w), "bn3": bn(next(keys), 4 * w)}
        if b == 0:
            blk["downsample_conv"] = conv(next(keys), 1, 1, cin, 4 * w)
            blk["downsample_bn"] = bn(next(keys), 4 * w)
        layer.append(blk)
        cin = 4 * w
    return layer


@pytest.mark.parametrize("H,W", [(8, 8), (8, 16)])
def test_chain_cp_plain_matches_jax_interpret(H, W):
    jblocks = small_params(jax.random.PRNGKey(0))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 8, H * W)))
    flat, meta = jpr.stage_chain_weights_cp(jblocks, 0, jnp.float32)
    want = np.asarray(jpr.bottleneck_chain_cp(jnp.asarray(x), flat, meta=meta, H=H, W=W,
                                              interpret=True))
    tflat, tmeta = tpr.stage_chain_weights_cp(_carry(jblocks), 0, torch.float32)
    assert tmeta == meta
    for a, b in zip(tflat, flat):  # the folded weights carry across exactly
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    got = tpr.bottleneck_chain_cp(torch.as_tensor(x), tflat, meta=tmeta, H=H, W=W)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_stem16_plain_matches_jax_interpret():
    jp = jresnet.random_params(jax.random.PRNGKey(0))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 16, 24, 3)))
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    xs = x.reshape(b, h2, 2, w2, 2, c).transpose(0, 2, 4, 5, 1, 3)
    x16 = np.pad(xs.reshape(b, 12, h2, w2), ((0, 0), (0, 4), (2, 1), (0, 0)))
    x16 = x16.reshape(b, 16, (h2 + 3) * w2)
    a, bias = jpr.fold_stem16_weights(jp["conv1_s2d"], jp["bn1"], jnp.float32)
    want = np.asarray(jpr.stem16(jnp.asarray(x16), a, bias, H2=h2, W2=w2, interpret=True))
    tp = _carry(jp)
    ta, tbias = tpr.fold_stem16_weights(tp["conv1_s2d"], tp["bn1"], torch.float32)
    np.testing.assert_allclose(ta.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tbias.numpy(), np.asarray(bias))
    got = tpr.stem16(torch.as_tensor(x16), ta, tbias, H2=h2, W2=w2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_stem_space_to_depth_matches_jax():
    jp = jresnet.random_params(jax.random.PRNGKey(2))
    x = np.array(jax.random.normal(jax.random.PRNGKey(3), (2, 16, 24, 3)))
    want = np.asarray(jresnet.stem_space_to_depth(jnp.asarray(x), jp["conv1_s2d"]))
    tp = _carry(jp)
    torch.testing.assert_close(tresnet.fold_stem_to_s2d(tp["conv1"]), tp["conv1_s2d"],
                               rtol=0, atol=0)
    got = tresnet.stem_space_to_depth(torch.as_tensor(x), tp["conv1_s2d"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("early", [False, True])
def test_extract_from_uint8_matches_jax(early):
    jp = jresnet.random_params(jax.random.PRNGKey(0))
    imgs = np.random.default_rng(0).integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(jresnet.extract_from_uint8(
        jresnet.ResNetConfig(early_pallas=early), jp, imgs))
    got = tresnet.extract_from_uint8(tresnet.ResNetConfig(early_pallas=early), _carry(jp),
                                     torch.as_tensor(imgs)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-2)


def test_early_kernels_match_plain_path_bf16():
    tp = tresnet.random_params(torch.Generator().manual_seed(0))
    imgs = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    base = tresnet.extract_from_uint8(
        tresnet.ResNetConfig(compute_dtype=torch.bfloat16), tp, imgs)
    early = tresnet.extract_from_uint8(
        tresnet.ResNetConfig(compute_dtype=torch.bfloat16, early_pallas=True), tp, imgs)
    assert early.dtype == torch.float32
    rel = (early - base).abs().max() / base.abs().max()
    assert float(rel) < 5e-2  # bf16 rounds at other places in the two paths


def test_resnet_from_torch_matches_jax_loader():
    sd = resnet50_sd(torch.Generator().manual_seed(0))
    jcfg, jp = jresnet.resnet_from_torch(sd)
    tcfg, tp = tresnet.resnet_from_torch(sd)
    assert tcfg.blocks_per_stage == jcfg.blocks_per_stage == (3, 4, 6, 3)
    assert tcfg.block == jcfg.block == "bottleneck"
    carried = _carry(jp)
    for name in ("conv1", "conv1_s2d"):
        torch.testing.assert_close(tp[name], carried[name], rtol=1e-6, atol=1e-7)
    for s in range(1, 5):
        for tb, jb in zip(tp[f"layer{s}"], carried[f"layer{s}"]):
            assert tb.keys() == jb.keys()
            for k in tb:
                if isinstance(tb[k], dict):
                    for kk in tb[k]:
                        torch.testing.assert_close(tb[k][kk], jb[k][kk], rtol=0, atol=0)
                else:
                    torch.testing.assert_close(tb[k], jb[k], rtol=0, atol=0)
    imgs = np.random.default_rng(1).integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(jresnet.extract_from_uint8(jcfg, jp, imgs))
    got = tresnet.extract_from_uint8(tcfg, tp, torch.as_tensor(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-2)


def test_avgpool7_top_left_window_at_256px_matches_jax():
    """A 256-px patch gives an 8x8 layer4 map, of which AvgPool2d(7) pools
    only the top-left 7x7 window."""
    cfg = tresnet.ResNetConfig()
    assert cfg.feature_dim_for(256, 256) == 2048
    assert cfg.feature_dim_for(512, 512) == 8192
    jp = jresnet.random_params(jax.random.PRNGKey(4))
    img = np.random.default_rng(4).integers(0, 256, size=(1, 256, 256, 3), dtype=np.uint8)
    want = np.asarray(jresnet.extract_from_uint8(jresnet.ResNetConfig(), jp, img))
    got = tresnet.extract_from_uint8(cfg, _carry(jp), torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-2)
