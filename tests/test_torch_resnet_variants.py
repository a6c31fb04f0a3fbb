"""The port's ResNet variants against the JAX package on the CPU: basic blocks
(resnet18 from a torchvision-format state dict), ``config_for_depth``, the 4-
and 1-channel stems (reference RNfour/RNone, ``pool_stride=1``) and the
``ResNetProject`` head."""

import numpy as np
import pytest
import torch

import jax

from sequoia_tpu.models import resnet as jresnet
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.models import resnet as tresnet


def _carry(jparams):
    return convert.resnet_params_from_numpy(jax.tree.map(np.asarray, jparams))


def resnet18_sd(seed=8):
    """A random torchvision-format resnet18 state dict (BasicBlock)."""
    rng = torch.Generator().manual_seed(seed)
    sd = {}

    def convw(name, cout, cin, k):
        sd[name + ".weight"] = (torch.randn(cout, cin, k, k, generator=rng)
                                * (cin * k * k) ** -0.5).double()

    def bn(name, c):
        sd[name + ".weight"] = (1 + 0.1 * torch.randn(c, generator=rng)).double()
        sd[name + ".bias"] = (0.1 * torch.randn(c, generator=rng)).double()
        sd[name + ".running_mean"] = (0.1 * torch.randn(c, generator=rng)).double()
        sd[name + ".running_var"] = (1 + 0.1 * torch.rand(c, generator=rng)).double()

    convw("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, nblocks in enumerate((2, 2, 2, 2)):
        cout = 64 * 2 ** s
        for b in range(nblocks):
            pre = f"layer{s + 1}.{b}."
            convw(pre + "conv1", cout, cin, 3)
            bn(pre + "bn1", cout)
            convw(pre + "conv2", cout, cout, 3)
            bn(pre + "bn2", cout)
            if b == 0 and s > 0:
                convw(pre + "downsample.0", cout, cin, 1)
                bn(pre + "downsample.1", cout)
            cin = cout
    return sd


@pytest.mark.parametrize("depth", [18, 34, 50, 101, 152])
def test_config_for_depth_matches_jax(depth):
    j, t = jresnet.config_for_depth(depth), tresnet.config_for_depth(depth)
    assert (t.blocks_per_stage, t.block, t.feature_dim) == (
        j.blocks_per_stage, j.block, j.feature_dim)


def test_basic_block_resnet18_matches_jax():
    sd = resnet18_sd()
    jcfg, jp = jresnet.resnet_from_torch(sd)
    tcfg, tp = tresnet.resnet_from_torch(sd)
    assert tcfg.block == "basic" and tcfg.blocks_per_stage == (2, 2, 2, 2)
    assert tcfg.feature_dim == 512
    imgs = np.random.default_rng(0).integers(0, 256, size=(2, 64, 64, 3), dtype=np.uint8)
    want = np.asarray(jresnet.extract_from_uint8(jcfg, jp, imgs))
    got = tresnet.extract_from_uint8(tcfg, tp, torch.as_tensor(imgs)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-2)
    # the kernel stage options take bottleneck blocks only: basic blocks run
    # the plain loop whatever they say, as in JAX
    opts = tresnet.ResNetConfig(blocks_per_stage=(2, 2, 2, 2), block="basic",
                                early_pallas=True, fused_stages=(1, 2), cp_stages=(3, 4))
    torch.testing.assert_close(tresnet.extract_from_uint8(opts, tp, torch.as_tensor(imgs)),
                               torch.as_tensor(got), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chans,size", [(4, 64), (1, 256)])
def test_channel_variants_match_jax(chans, size):
    maker = {4: jresnet.resnet50_4channel, 1: jresnet.resnet50_1channel}[chans]
    jp = maker(key=jax.random.PRNGKey(0))
    tp = _carry(jp)
    assert tuple(tp["conv1_s2d"].shape) == (64, 4 * chans, 4, 4)
    x = np.random.default_rng(1).random((1, size, size, chans)).astype(np.float32)
    cfg = dict(pool_stride=1)
    want = np.asarray(jresnet.forward_extract(jresnet.ResNetConfig(**cfg), jp, x))
    got = tresnet.forward_extract(tresnet.ResNetConfig(**cfg), tp, torch.as_tensor(x)).numpy()
    # 256 px: the 8x8 layer4 map pools 2x2 windows at stride 1
    assert got.shape == (1, tresnet.ResNetConfig(**cfg).feature_dim_for(size, size))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-2)


@pytest.mark.parametrize("chans", [4, 1])
def test_random_channel_variants_rebuild_the_s2d_stem(chans):
    maker = {4: tresnet.resnet50_4channel, 1: tresnet.resnet50_1channel}[chans]
    tp = maker(gen=torch.Generator().manual_seed(0))
    assert tuple(tp["conv1"].shape) == (64, chans, 7, 7)
    torch.testing.assert_close(tp["conv1_s2d"], tresnet.fold_stem_to_s2d(tp["conv1"]))
    x = torch.rand((2, 64, 64, chans), generator=torch.Generator().manual_seed(1))
    out = tresnet.forward_extract(tresnet.ResNetConfig(pool_stride=1), tp, x)
    assert out.shape == (2, 2048) and bool(torch.isfinite(out).all())


def test_resnet_project_matches_jax():
    jcfg = jresnet.ResNetProjectConfig(hdim=16)
    jproj = jresnet.resnet_project_init(jcfg, jax.random.PRNGKey(1))
    jback = jresnet.random_params(jax.random.PRNGKey(0))
    tcfg = tresnet.ResNetProjectConfig(hdim=16)
    tproj = {k: torch.as_tensor(np.array(v)) for k, v in jproj.items()}
    tback = _carry(jback)
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jresnet.resnet_project_forward(jcfg, jproj, jback, x))
    got = tresnet.resnet_project_forward(tcfg, tproj, tback, torch.as_tensor(x)).numpy()
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)
    feats = tresnet.resnet_project_extract(tcfg, tproj, tback, torch.as_tensor(x))
    # training dropout: zeros where dropped, the rest scaled by 1/(1-p)
    drop = tresnet.resnet_project_extract(tcfg, tproj, tback, torch.as_tensor(x), train=True,
                                          gen=torch.Generator().manual_seed(3))
    kept = drop != 0
    assert 0 < int(kept.sum()) < kept.numel()
    torch.testing.assert_close(drop[kept], feats[kept] / (1.0 - tcfg.dropout))


def test_resnet_project_init_shapes_and_bounds():
    cfg = tresnet.ResNetProjectConfig()
    p = tresnet.resnet_project_init(cfg, torch.Generator().manual_seed(0))
    assert tuple(p["project_w"].shape) == (2048, 200) and tuple(p["fc_w"].shape) == (200, 1)
    assert float(p["project_w"].abs().max()) <= 2048 ** -0.5
    assert float(p["fc_b"].abs().max()) <= 200 ** -0.5
