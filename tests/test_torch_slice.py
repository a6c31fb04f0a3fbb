"""The whole slice on the CPU: uint8 patches -> ResNet-50 (early_pallas) ->
k-means cluster means -> 2-fold ViS ensemble, through the port and through
the JAX package with the same weights, and the port's entry points end to
end."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.models import resnet as jresnet
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.ops import kmeans as jkm
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.models import resnet as tresnet
from sequoia_tpu_torch.models import vis as tvis
from sequoia_tpu_torch.ops import kmeans as tkm
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.pipeline.fused import make_slide_program
from sequoia_tpu_torch.serve import SlidePredictor

K, G, PATCHES, SLIDES = 8, 64, 10, 4
VIS = dict(num_outputs=G, input_dim=2048, depth=2, nheads=16, dim_f=64, dim_s=64,
           dim_c=64, num_clusters=K)


@pytest.fixture(scope="module")
def models():
    jres = jresnet.random_params(jax.random.PRNGKey(0))
    jcfg = jvis.ViSConfig(**VIS)
    jfolds = [jvis.init(jcfg, jax.random.PRNGKey(10 + i)) for i in range(2)]
    tres = convert.resnet_params_from_numpy(jax.tree.map(np.asarray, jres))
    tfolds = [convert.vis_params_from_numpy(jax.tree.map(np.asarray, p)) for p in jfolds]
    return jres, jcfg, jfolds, tres, tvis.ViSConfig(**VIS), tfolds


def _slides(seed=0):
    rng = np.random.default_rng(seed)
    slides = rng.integers(0, 256, size=(SLIDES, PATCHES, 32, 32, 3), dtype=np.uint8)
    slides[0, :2] = 0  # all-zero patches (padding) ride along
    slides[2, 5] = 0
    return slides


def _jax_slide(models, u8):
    jres, jcfg, jfolds, *_ = models
    feats = np.asarray(jresnet.extract_from_uint8(jresnet.ResNetConfig(early_pallas=True),
                                                  jres, u8))
    cf = np.nan_to_num(jkm.kmeans_cluster_features(feats, K, seed=0, backend="hybrid"))
    return np.mean([np.asarray(jvis.apply(jcfg, p, jnp.asarray(cf[None])))
                    for p in jfolds], axis=0)


@pytest.mark.parametrize("fused_vis", [True, False])
def test_slice_matches_jax_f32(models, fused_vis):
    *_, tres, tcfg, tfolds = models
    pred = SlidePredictor(None, [(tcfg, p) for p in tfolds], n_clusters=K,
                          use_fused_vis=fused_vis, device="cpu")
    slides = _slides()
    want = np.concatenate([_jax_slide(models, u8) for u8 in slides])
    got = []
    for u8 in slides:
        feats = tresnet.extract_from_uint8(tresnet.ResNetConfig(early_pallas=True), tres,
                                           torch.as_tensor(u8))
        cf = np.nan_to_num(tkm.kmeans_cluster_features(feats.numpy(), K, seed=0,
                                                       backend="hybrid", device="cpu"))
        got.append(pred.predict_cluster_features(cf))
    got = np.concatenate(got)
    assert got.shape == (SLIDES, G)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4
    # per-gene Pearson r against a target across slides (docs/PARITY_NOTES.md)
    target = np.random.default_rng(1).normal(size=(SLIDES, G))

    def per_gene_r(p):
        pc, tc = p - p.mean(0), target - target.mean(0)
        return (pc * tc).sum(0) / np.sqrt((pc ** 2).sum(0) * (tc ** 2).sum(0))

    assert np.abs(per_gene_r(got) - per_gene_r(want)).max() <= 1e-3


def test_slide_predictor_predict_patches_on_cpu(models):
    *_, tres, tcfg, tfolds = models
    ext = FeatureExtractor("resnet", tres, batch_size=4, patch_size=32, device="cpu",
                           cfg=tresnet.ResNetConfig(early_pallas=True))
    pred = SlidePredictor(ext, [(tcfg, p) for p in tfolds], n_clusters=K,
                          use_pallas_kmeans=True, device="cpu")
    slides = _slides(2)
    for u8 in (slides[0], slides[1, :5]):  # the second has fewer patches than k
        y = pred.predict_patches(u8)
        assert y.shape == (1, G) and np.isfinite(y).all()
    # the tail block is padded to the batch and cut off again
    np.testing.assert_allclose(ext(slides[1, :5]), ext(slides[1])[:5], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="no tissue"):
        pred.predict_features(np.zeros((0, 2048), np.float32))


@pytest.mark.parametrize("kernels", [True, False])
def test_slide_program_masks_zero_patches(models, kernels):
    *_, tres, tcfg, tfolds = models
    run = make_slide_program(tres, tcfg, tfolds[0], n_clusters=K,
                             compute_dtype=torch.float32, kernels=kernels, device="cpu")
    batches = _slides(3).reshape(2, 2 * PATCHES, 32, 32, 3)
    y = run(batches, torch.Generator().manual_seed(0))
    assert y.shape == (G,) and bool(torch.isfinite(y).all())
    # a slide that is all padding but for 3 patches: fewer valid patches
    # than clusters, NaN means zeroed
    batches[:, 3:] = 0
    y = run(batches, torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(y).all())
