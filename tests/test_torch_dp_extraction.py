"""In-process data parallelism on the CPU: the port's ``FeatureExtractor``
over a ``[cpu, cpu]`` mesh against the single-device extractor and against
JAX's ``FeatureExtractor(mesh=make_mesh(n_data=2))`` on two virtual devices
(tests/test_graft_entry.py's DP tolerance, rtol 2e-3 / atol 1e-2); a
``SlidePredictor`` over the data-parallel extractor (the screen and backbone
per shard) against the single-device predictor; and the window stage over
(2, 1), (1, 2) and (2, 2) meshes against the unsharded stage and JAX's
sharded stage (tests/test_torch_spatial.py's 1e-4)."""

import numpy as np
import pytest
import torch

import jax

from sequoia_tpu.models import resnet as jresnet
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.parallel import sharding as jsh
from sequoia_tpu.pipeline import features as jfeat
from sequoia_tpu.pipeline import spatial as jspatial
from sequoia_tpu_torch.data.wsi import ArrayReader
from sequoia_tpu_torch.models import convert, vis
from sequoia_tpu_torch.models import resnet as tresnet
from sequoia_tpu_torch.parallel import sharding as sh
from sequoia_tpu_torch.pipeline import spatial
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.serve import SlidePredictor
from tests.test_pipeline_e2e import synthetic_wsi
from tests.test_spatial import make_grid_df
from tests.test_torch_serve_wsi import _to_jax

PS, BATCH, BLOCKS, K, CAP = 64, 8, (1, 1, 1, 1), 4, 24
TWO = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def backbone():
    tres = tresnet.random_params(torch.Generator().manual_seed(0))
    tres.update({f"layer{s}": tres[f"layer{s}"][:1] for s in range(1, 5)})
    return tres, tresnet.ResNetConfig(blocks_per_stage=BLOCKS)


def test_dp_extractor_matches_single_device_and_jax(backbone):
    tres, cfg = backbone
    u8 = np.random.default_rng(0).integers(0, 256, (13, PS, PS, 3), dtype=np.uint8)
    one = FeatureExtractor("resnet", tres, batch_size=BATCH // 2, patch_size=PS, cfg=cfg,
                           device="cpu")
    dp = FeatureExtractor("resnet", tres, batch_size=BATCH, patch_size=PS, cfg=cfg,
                          mesh=sh.make_mesh(2, devices=TWO))
    assert dp.device.type == "cpu" and len(dp._replicas) == 1
    got = dp(u8)
    assert got.shape == (13, 2048)
    # each device's shard is the single device's batch of BATCH // 2
    np.testing.assert_allclose(got, one(u8), rtol=1e-5, atol=1e-5)
    jext = jfeat.FeatureExtractor(
        "resnet", jresnet.enable_s2d_stem(_to_jax(tres)), batch_size=BATCH, patch_size=PS,
        cfg=jresnet.ResNetConfig(blocks_per_stage=BLOCKS),
        mesh=jsh.make_mesh(n_data=2, devices=jax.devices()[:2]))
    np.testing.assert_allclose(got, jext(u8), rtol=2e-3, atol=1e-2)
    # the shards run through raw_fwd on an uploaded batch too
    shards = []
    dp.map_shards(lambda p, x: shards.append(x.shape[0]) or x.float().mean((1, 2, 3)), dp.params,
                  dp.upload(u8[:BATCH]))
    assert shards == [BATCH // 2, BATCH // 2]
    with pytest.raises(ValueError, match="not divisible by mesh data axis 2"):
        FeatureExtractor("resnet", tres, batch_size=5, cfg=cfg, mesh=sh.make_mesh(2, devices=TWO))


def test_dp_serving_matches_single_device(backbone):
    tres, cfg = backbone
    vcfg = vis.ViSConfig(num_outputs=5, input_dim=2048, depth=1, nheads=2, dim_f=4, dim_s=4,
                         dim_c=4, num_clusters=K)
    folds = [(vcfg, vis.init(vcfg, torch.Generator().manual_seed(i))) for i in range(2)]
    kw = dict(n_clusters=K, max_patches=CAP, patch_size=PS, device="cpu")
    one = SlidePredictor(FeatureExtractor("resnet", tres, batch_size=BATCH // 2, patch_size=PS,
                                          cfg=cfg, device="cpu"), folds, **kw)
    dp = SlidePredictor(FeatureExtractor("resnet", tres, batch_size=BATCH, patch_size=PS,
                                         cfg=cfg, mesh=sh.make_mesh(2, devices=TWO)),
                        folds, **kw)
    jslide = synthetic_wsi()
    slide = ArrayReader([lv.copy() for lv in jslide.levels], properties=dict(jslide.properties))
    got, want = dp.predict_wsi(slide), one.predict_wsi(slide)
    assert got.shape == (1, 5) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert dp.io_stats["kept"] == one.io_stats["kept"] == CAP
    u8 = np.random.default_rng(1).integers(0, 256, (10, PS, PS, 3), dtype=np.uint8)
    np.testing.assert_allclose(dp.predict_patches(u8), one.predict_patches(u8),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_dp_window_stage_matches_unsharded_and_jax(shape):
    D, G = 16, 6
    kw = dict(num_outputs=G, input_dim=D, depth=1, nheads=2, dim_f=4, dim_s=4, dim_c=4,
              num_clusters=100)
    jcfg = jvis.ViSConfig(**kw)
    jp = {f: jvis.init(jcfg, jax.random.PRNGKey(f)) for f in range(2)}
    tp = {f: convert.vis_params_from_numpy(jax.tree.map(np.asarray, p)) for f, p in jp.items()}
    rng = np.random.default_rng(5)
    df = make_grid_df(rng, nx=16, ny=16, keep=0.9)
    feats = rng.normal(size=(len(df), D)).astype(np.float32)
    mesh = sh.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    multi = spatial.make_vis_stacked_predict_fn(vis.ViSConfig(**kw), tp, mesh=mesh)
    cell_bytes = [sum(p["head_w"].numel() * 4 for p in c.values())
                  for row in multi.raw_fwd.cells for c in row]
    assert all(b * shape[1] == 2 * D * G * 4 for b in cell_bytes)
    genes = [0, 2, 5]
    args = dict(stride=2, batch_windows=5)
    keys, got, seen = spatial.sliding_window_predict_arrays(feats, df, multi, genes, mesh=mesh,
                                                            **args)
    _, want, wseen = spatial.sliding_window_predict_arrays(
        feats, df, spatial.make_vis_stacked_predict_fn(vis.ViSConfig(**kw), tp), genes,
        accumulate="device", **args)
    jmesh = jsh.make_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])
    jkeys, jgot, jseen = jspatial.sliding_window_predict_arrays(
        feats, df, jspatial.make_vis_stacked_predict_fn(jcfg, jp, mesh=jmesh), genes,
        mesh=jmesh, **args)
    assert keys == jkeys == [0, 1] and seen.sum() > 100
    np.testing.assert_array_equal(seen, wseen)
    np.testing.assert_array_equal(seen, jseen)
    for f in keys:
        np.testing.assert_allclose(got[f], want[f], rtol=2e-5, atol=2e-6)
        assert np.nanmax(np.abs(got[f] - jgot[f])) < 1e-4
