"""The port's slide serving from a WSI (``SlidePredictor.predict_wsi``)
against the JAX package's on the CPU, on the synthetic slide of
tests/test_pipeline_e2e.py: the same kept patches, features within the
extractor's tolerance, and the same prediction through shared clustering."""

import sys

import numpy as np
import pytest
import torch

import jax

from sequoia_tpu.data.wsi import ArrayReader as JReader
from sequoia_tpu.models import resnet as jresnet
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.ops import kmeans as jkm
from sequoia_tpu.pipeline.features import FeatureExtractor as JExtractor
from sequoia_tpu.serve import SlidePredictor as JPredictor
from sequoia_tpu_torch.data.wsi import ArrayReader
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.models import resnet as tresnet
from sequoia_tpu_torch.models import vis as tvis
from sequoia_tpu_torch.ops import kmeans as tkm
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.serve import SlidePredictor
from tests.test_pipeline_e2e import synthetic_wsi

K, PS, BATCH, CAP = 8, 64, 16, 48
VIS = dict(num_outputs=5, input_dim=2048, depth=1, nheads=2, dim_f=4, dim_s=4, dim_c=4,
           num_clusters=K)


def _to_jax(node):
    """The port's ResNet tree (OIHW convs) -> the JAX package's (HWIO); the
    s2d stem is folded again on the JAX side."""
    if isinstance(node, dict):
        return {k: (np.asarray(v).transpose(2, 3, 1, 0) if k.startswith("conv")
                    or k == "downsample_conv" else _to_jax(v))
                for k, v in node.items() if k != "conv1_s2d"}
    if isinstance(node, list):
        return [_to_jax(v) for v in node]
    return np.asarray(node)


@pytest.fixture(scope="module")
def predictors():
    tres = tresnet.random_params(torch.Generator().manual_seed(0))
    jres = jresnet.enable_s2d_stem(_to_jax(tres))
    jcfg = jvis.ViSConfig(**VIS)
    jfolds = [(jcfg, jvis.init(jcfg, jax.random.PRNGKey(i))) for i in range(2)]
    jpred = JPredictor(JExtractor("resnet", jres, batch_size=BATCH, patch_size=PS), jfolds,
                       n_clusters=K, max_patches=CAP, patch_size=PS)
    tfolds = [(tvis.ViSConfig(**VIS),
               convert.vis_params_from_numpy(jax.tree.map(np.asarray, p))) for _, p in jfolds]
    text = FeatureExtractor("resnet", tres, batch_size=BATCH, patch_size=PS, device="cpu")
    tpred = SlidePredictor(text, tfolds, n_clusters=K, max_patches=CAP, patch_size=PS,
                           device="cpu")
    return jpred, tpred


def _port_reader(jslide):
    return ArrayReader([lv.copy() for lv in jslide.levels], properties=dict(jslide.properties))


def _capture(pred):
    """Record the features each predict_features call receives."""
    seen = []
    orig = pred.predict_features

    def spy(feats):
        seen.append(np.asarray(feats.cpu() if isinstance(feats, torch.Tensor) else feats))
        return orig(feats)

    pred.predict_features = spy
    return seen


def test_predict_wsi_matches_jax(predictors):
    jpred, tpred = predictors
    jslide = synthetic_wsi()
    tslide = _port_reader(jslide)
    # the kept patches: the first CAP candidates that pass the screen
    want_patches = jpred.extract_patches(jslide)
    got_patches = tpred.extract_patches(tslide)
    assert got_patches.shape == want_patches.shape == (CAP, PS, PS, 3)
    np.testing.assert_array_equal(got_patches, want_patches)

    jseen, tseen = _capture(jpred), _capture(tpred)
    try:
        want = jpred.predict_wsi(jslide)
        before = dict(tpred.io_stats)
        got = tpred.predict_wsi(tslide)
    finally:
        del jpred.predict_features, tpred.predict_features
    assert got.shape == want.shape == (1, 5) and np.isfinite(got).all()
    (jf,), (tf,) = jseen, tseen
    assert tf.shape == jf.shape == (CAP, 2048)
    np.testing.assert_allclose(tf, jf, rtol=2e-4, atol=1e-2)
    assert tpred.io_stats["kept"] - before["kept"] == CAP
    assert tpred.io_stats["candidates"] - before["candidates"] >= CAP
    # streamed features are the features of the kept patches
    np.testing.assert_allclose(tf, tpred.extractor(got_patches), rtol=1e-5, atol=1e-5)

    # the prediction through shared clustering (both sides' k-means on the
    # host backend from one seed), as tests/test_torch_slice.py
    jcf = np.nan_to_num(jkm.kmeans_cluster_features(jf, K, seed=0, backend="hybrid"))
    tcf = np.nan_to_num(tkm.kmeans_cluster_features(tf, K, seed=0, backend="hybrid",
                                                    device="cpu"))
    jy = jpred.predict_cluster_features(jcf)
    ty = tpred.predict_cluster_features(tcf)
    # features within 2e-4 relative move the small ViS output by as much
    np.testing.assert_allclose(ty, jy, rtol=1e-3, atol=1e-4)


def test_screened_mode_keeps_the_jax_patches(predictors):
    """AppMag 40: candidates are read at twice the patch size, screened, and
    the survivors resized with Pillow, as in JAX."""
    jpred, tpred = predictors
    j0 = synthetic_wsi(seed=1)
    jslide = JReader(j0.levels, properties={"aperio.AppMag": "40"})
    tslide = ArrayReader([lv.copy() for lv in j0.levels], properties={"aperio.AppMag": "40"})
    want = jpred.extract_patches(jslide)
    got = tpred.extract_patches(tslide)
    assert got.shape == want.shape and got.shape[1:] == (PS, PS, 3) and len(got) > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reader", ["pil_tiff", "array_reader"])
def test_predict_slides_through_the_cards_reader(predictors, tmp_path, monkeypatch, reader):
    """The H100 machine builds no native tiff reader and has no OpenSlide, so
    its slide files are read by Pillow: a Pillow-written pyramid TIFF opened
    by ``data/wsi.open_slide`` with both masked, and the same levels as an
    ``ArrayReader``, each served through ``predict_slides`` in ``'rgb'``,
    give the genes ``predict_patches`` gives on the patches the JAX
    package's tiling keeps."""
    from PIL import Image

    from sequoia_tpu_torch import native
    from sequoia_tpu_torch.data import wsi

    jpred, tpred = predictors
    levels = [lv.copy() for lv in synthetic_wsi(w=1024, h=768, seed=2).levels]
    kept = jpred.extract_patches(JReader(levels))
    np.testing.assert_array_equal(tpred.extract_patches(ArrayReader(levels)), kept)
    want = tpred.predict_patches(kept)
    if reader == "pil_tiff":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setitem(sys.modules, "openslide", None)
        slide = str(tmp_path / "slide.tiff")
        Image.fromarray(levels[0]).save(slide, save_all=True,
                                        append_images=[Image.fromarray(lv) for lv in levels[1:]])
        assert isinstance(wsi.open_slide(slide), wsi.PILReader)
    else:
        slide = ArrayReader(levels)
    modes = []
    start = tpred._start_producer

    def spy(*args, **kw):
        out = start(*args, **kw)
        modes.append(out[4])
        return out

    monkeypatch.setattr(tpred, "_start_producer", spy)
    before = tpred.io_stats["kept"]
    (path, got), = list(tpred.predict_slides([slide]))
    assert path is slide and modes == ["rgb"]
    assert tpred.io_stats["kept"] - before == len(kept) > K
    assert got.shape == want.shape == (1, 5) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
