"""The port's raw-plane serving modes (``SlidePredictor`` ``'ycbcr'`` and
``'mosaic'``) on JPEG-tiled slides written by the port's native writer:
each against ``'rgb'`` on the same reader and predictor, the mosaic against
``predict_patches(extract_patches(...))`` with and without a binding
``max_patches`` (tests/test_mosaic.py's rtol 2e-4 / atol 1e-4), the kept
features against the JAX predictor's on the same file, the ``OSError``
retry in ``'rgb'``, and a two-device CPU mesh against one device."""

import numpy as np
import pytest
import torch

import jax

from sequoia_tpu.models import resnet as jresnet
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.pipeline.features import FeatureExtractor as JExtractor
from sequoia_tpu.serve import SlidePredictor as JPredictor
from sequoia_tpu_torch import native
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.models import resnet as tresnet
from sequoia_tpu_torch.models import vis as tvis
from sequoia_tpu_torch.ops import ycbcr
from sequoia_tpu_torch.parallel import sharding as sh
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.serve import SlidePredictor
from tests.test_torch_serve_wsi import BATCH, CAP, K, PS, VIS, _to_jax

if not native.available():
    pytest.skip("the port's native reader did not build", allow_module_level=True)

T = 48  # the mosaic's tile side: a multiple of 16 (JPEG MCUs), not the patch size
W, H = 6 * PS + 40, 5 * PS + 16  # edge tiles on both axes
SLIDES = {"y22": (PS, (2, 2)), "y21": (PS, (2, 1)), "m22": (T, (2, 2))}


def _write(path, tile, sub, seed=3):
    """Tissue colours over the slide but for a background band, so the
    screen rejects some candidates; level 1 for the slide mask."""
    rng = np.random.default_rng(seed)
    lv0 = np.empty((H, W, 3), np.uint8)
    lv0[..., 0] = rng.integers(150, 220, (H, W))
    lv0[..., 1] = rng.integers(60, 140, (H, W))
    lv0[..., 2] = rng.integers(150, 230, (H, W))
    lv0[:, :PS + PS // 2] = 242
    native.write_tiled_tiff(path, [lv0, lv0[::4, ::4].copy()], tile=(tile, tile),
                            jpeg_quality=80, subsampling=sub,
                            description="synthetic|AppMag = 20")


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    out = {}
    for name, (tile, sub) in SLIDES.items():
        out[name] = str(root / f"{name}.tiff")
        _write(out[name], tile, sub)
    return out


@pytest.fixture(scope="module")
def models():
    tres = tresnet.random_params(torch.Generator().manual_seed(0))
    jcfg = jvis.ViSConfig(**VIS)
    jfolds = [(jcfg, jvis.init(jcfg, jax.random.PRNGKey(i))) for i in range(2)]
    tfolds = [(tvis.ViSConfig(**VIS),
               convert.vis_params_from_numpy(jax.tree.map(np.asarray, p))) for _, p in jfolds]
    return tres, jfolds, tfolds


def _predictor(models, batch=BATCH, mesh=None):
    tres, _, tfolds = models
    device = None if mesh is not None else "cpu"
    ext = FeatureExtractor("resnet", tres, batch_size=batch, patch_size=PS, mesh=mesh,
                           device=device)
    return SlidePredictor(ext, tfolds, n_clusters=K, max_patches=CAP, patch_size=PS,
                          device="cpu")


@pytest.fixture(scope="module")
def pred(models):
    return _predictor(models)


def _mode(pred, path, force_rgb=False):
    tup = pred._start_producer(path, force_rgb=force_rgb)
    tup[3].set()
    tup[1].join(timeout=30)
    return tup[4], tup[5]


def _serve(pred, path, force_rgb=False):
    """(prediction, kept features, io_stats deltas) of one slide."""
    seen, orig = [], pred.predict_features
    pred.predict_features = lambda f: seen.append(f.clone()) or orig(f)
    before = dict(pred.io_stats)
    try:
        if force_rgb:
            out = pred._consume_retrying(path, pred._start_producer(path, force_rgb=True))
        else:
            out = pred.predict_wsi(path)
    finally:
        del pred.predict_features
    return out, seen[0].numpy(), {k: pred.io_stats[k] - before[k] for k in before}


@pytest.mark.parametrize("name", ["y22", "y21"])
def test_ycbcr_mode_matches_rgb(pred, slides, name):
    path, sub = slides[name], SLIDES[name][1]
    assert _mode(pred, path) == ("ycbcr", sub)
    assert _mode(pred, path, force_rgb=True)[0] == "rgb"
    # per chunk: the reconstruction, masked to each extent, is the RGB decode
    rgb_chunks = list(pred.iter_raw_chunks(path))
    ycc_chunks = list(pred.iter_raw_ycbcr_chunks(path))
    assert len(rgb_chunks) == len(ycc_chunks)
    for rgb, (planes, wh) in zip(rgb_chunks, ycc_chunks):
        rec = ycbcr.mask_to_valid(ycbcr.planar_to_rgb(torch.from_numpy(planes), PS, PS, *sub),
                                  torch.from_numpy(wh))
        np.testing.assert_array_equal(rec.numpy(), rgb)
    assert any((wh < PS).any() for _, wh in ycc_chunks), "the fixture has edge tiles"

    out, feats, stats = _serve(pred, path)
    want, wfeats, wstats = _serve(pred, path, force_rgb=True)
    assert out.shape == (1, 5) and np.isfinite(out).all()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
    assert stats["kept"] == wstats["kept"] == len(feats) > 0
    assert stats["candidates"] == wstats["candidates"] > stats["kept"]  # the band is screened
    np.testing.assert_allclose(feats, wfeats, rtol=1e-5, atol=1e-5)
    ny, nc = ycbcr.planar_sizes(PS, PS, *sub)
    assert stats["bytes_uploaded"] / wstats["bytes_uploaded"] <= (ny + 2 * nc) / (3 * ny) + 0.05


@pytest.mark.parametrize("cap", [CAP, 10])
def test_mosaic_mode_matches_predict_patches(pred, slides, cap):
    path = slides["m22"]
    assert _mode(pred, path) == ("mosaic", (T, T, 2, 2))
    chunks = list(pred.iter_mosaic_chunks(path))
    assert sorted(np.concatenate([c[4] for c in chunks]).tolist()) == list(
        range(len(pred._candidates(path)[1])))  # every candidate once
    tissue = len(pred.extract_patches(path))  # every candidate that passes: CAP does not bind
    assert CAP > tissue > 10
    pred.max_patches = cap
    try:
        out, feats, stats = _serve(pred, path)
        patches = pred.extract_patches(path)
        want = pred.predict_patches(patches)
        _, wfeats, wstats = _serve(pred, path, force_rgb=True)
    finally:
        pred.max_patches = CAP
    assert len(patches) == stats["kept"] == wstats["kept"] == min(cap, tissue)
    np.testing.assert_allclose(out, want, rtol=2e-4, atol=1e-4)
    # the kept set, in the reference's shuffle order
    np.testing.assert_allclose(feats, pred.extractor(patches), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(feats, wfeats, rtol=1e-5, atol=1e-5)
    # each tile crosses once, as 4:2:0 planes
    assert stats["bytes_uploaded"] < wstats["bytes_uploaded"]


@pytest.mark.parametrize("name,mode", [("y22", "ycbcr"), ("m22", "mosaic")])
def test_raw_modes_keep_the_jax_features(models, pred, slides, name, mode):
    tres, jfolds, _ = models
    jpred = JPredictor(JExtractor("resnet", jresnet.enable_s2d_stem(_to_jax(tres)),
                                  batch_size=BATCH, patch_size=PS),
                       jfolds, n_clusters=K, max_patches=CAP, patch_size=PS)
    tup = jpred._start_producer(slides[name])
    tup[3].set()
    tup[1].join(timeout=30)
    assert tup[4] == mode
    jseen, jorig = [], jpred.predict_features
    jpred.predict_features = lambda f: jseen.append(np.asarray(f)) or jorig(f)
    jpred.predict_wsi(slides[name])
    _, feats, _ = _serve(pred, slides[name])
    (jf,) = jseen
    assert feats.shape == jf.shape and len(jf) > 0
    np.testing.assert_allclose(feats, jf, rtol=2e-4, atol=1e-2)


class _FailingRaw:
    """A native reader whose raw-plane read fails with OSError, as a strict
    read of a corrupt tile does."""

    def __init__(self, path):
        self._r = native.NativeTiffReader(path)
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._r, name)

    def read_regions_ycbcr(self, *a, **k):
        self.calls += 1
        raise OSError("read_regions_ycbcr decoded 0/1 regions")


@pytest.mark.parametrize("name,mode", [("y22", "ycbcr"), ("m22", "mosaic")])
def test_oserror_retries_in_rgb(pred, slides, name, mode):
    bad = _FailingRaw(slides[name])
    assert _mode(pred, bad)[0] == mode
    bad.calls = 0
    out = pred.predict_wsi(bad)
    want = _serve(pred, slides[name], force_rgb=True)[0]
    assert bad.calls == 1
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["y22", "m22"])
def test_two_device_mesh_matches_one(models, slides, name):
    """Under a [cpu, cpu] mesh the planes (or the mosaic's idx/offs/wh) shard
    with the batch and each device reads its own copy of the tile stack;
    one device at the per-device batch gives the same prediction."""
    one = _predictor(models, batch=BATCH // 2)
    dp = _predictor(models, mesh=sh.make_mesh(2, devices=["cpu", "cpu"]))
    assert _mode(dp, slides[name])[0] == _mode(one, slides[name])[0]
    got, gfeats, gstats = _serve(dp, slides[name])
    want, wfeats, wstats = _serve(one, slides[name])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gfeats, wfeats, rtol=1e-5, atol=1e-5)
    assert gstats["kept"] == wstats["kept"]
