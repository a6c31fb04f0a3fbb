"""Port run_visualize and cli.visualize against the JAX package on the CPU:
the same ``stride-{stride}.csv`` per tile per gene within 1e-4
(docs/PARITY_NOTES.md:151-158) on the synthetic TCGA-layout workspace of
tests/test_cli_visualize.py, for ViS, HE2RNA and ViT folds.  Both sides get
one tile featuriser (the mean RGB of a tile, repeated to 12 features), so the
comparison holds the grid, the windows, the fold models and the overlap
averaging; the port's real extractor route (the Pillow-exact resize, then
the backbone) is held on its own."""

import json
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from sequoia_tpu.cli import visualize as jviz
from sequoia_tpu.models import convert as jconvert
from sequoia_tpu.models import he2rna as jhe
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.models import vit as jvit
from sequoia_tpu.pipeline import patch_gen as jpatch_gen
from sequoia_tpu.pipeline import spatial as jspatial
from sequoia_tpu_torch import native
from sequoia_tpu_torch.cli import serve as tserve
from sequoia_tpu_torch.cli import visualize as tviz
from sequoia_tpu_torch.models import convert, vis
from sequoia_tpu_torch.pipeline import spatial
from sequoia_tpu_torch.train import checkpoint
from tests.test_pipeline_e2e import synthetic_wsi

DIM, PROJECT, WSI = 12, "TCGA-SYN", "TCGA-AA-0001.svs"


def pool_features(tiles):
    """(n, ps, ps, 3) uint8 -> (n, 12): each tile's mean RGB, four times."""
    t = np.asarray(tiles).astype(np.float32) / 255.0
    return np.tile(t.reshape(t.shape[0], -1, 3).mean(axis=1), (1, 4)).astype(np.float32)


class PoolExtractor:
    device = torch.device("cpu")

    def __call__(self, tiles):
        return pool_features(tiles)


def test_run_visualize_matches_jax(tmp_path):
    slide = synthetic_wsi()
    mask, _ = jpatch_gen.compute_slide_mask(slide)
    genes = [f"G{i}" for i in range(4)]
    cfg = jvis.ViSConfig(num_outputs=4, input_dim=DIM, depth=1, nheads=2, dim_f=4, dim_s=4,
                         dim_c=4, num_clusters=100)
    jp = {f: jvis.init(cfg, jax.random.PRNGKey(f)) for f in range(2)}
    tcfg = vis.ViSConfig(num_outputs=4, input_dim=DIM, depth=1, nheads=2, dim_f=4, dim_s=4,
                         dim_c=4, num_clusters=100)
    tp = {f: convert.vis_params_from_numpy(jax.tree.map(np.asarray, p)) for f, p in jp.items()}
    kw = dict(gene_names=["G1", "G2", "nope"], patch_size=64, stride=2)
    want = jspatial.run_visualize(slide, mask, genes, {f: jspatial.make_vis_predict_fn(cfg, p)
                                                       for f, p in jp.items()},
                                  pool_features, save_path=str(tmp_path / "jax"), **kw)
    got = spatial.run_visualize(slide, mask, genes, spatial.make_vis_stacked_predict_fn(tcfg, tp),
                                PoolExtractor(), save_path=str(tmp_path / "port"), **kw)
    assert list(got.columns) == list(want.columns) == [
        "xcoord", "ycoord", "xcoord_tf", "ycoord_tf", "G1_0", "G2_0", "G1_1", "G2_1", "G1", "G2"]
    _assert_same_map(got, want)
    on_disk = pd.read_csv(tmp_path / "port" / "stride-2.csv", index_col=0)
    _assert_same_map(on_disk, pd.read_csv(tmp_path / "jax" / "stride-2.csv", index_col=0))
    pd.testing.assert_series_equal(got["G1"], got[["G1_0", "G1_1"]].mean(axis=1),
                                   check_names=False)


def _assert_same_map(got, want):
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for c in ("xcoord", "ycoord", "xcoord_tf", "ycoord_tf"):
        np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy())
    vals = [c for c in want.columns if c not in ("xcoord", "ycoord", "xcoord_tf", "ycoord_tf")]
    a, b = got[vals].to_numpy(float), want[vals].to_numpy(float)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    assert (~np.isnan(b)).sum() > 5 * len(vals)
    assert np.nanmax(np.abs(a - b)) < 1e-4


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The reference TCGA layout: the slide file, its stage-1 mask, and
    ViS, HE2RNA and ViT fold checkpoints with ``test_results.pkl``."""
    root = tmp_path_factory.mktemp("viz")
    slide = synthetic_wsi()
    os.makedirs(root / "TCGA" / PROJECT)
    native.write_tiled_tiff(str(root / "TCGA" / PROJECT / WSI), slide.levels, tile=(128, 128))
    mask, _ = jpatch_gen.compute_slide_mask(slide)
    os.makedirs(root / "TCGA" / f"{PROJECT}_Masks" / WSI[:-4])
    np.save(root / "TCGA" / f"{PROJECT}_Masks" / WSI[:-4] / "mask.npy", mask)
    genes = [f"G{i}" for i in range(5)]
    for model_type in ("vis", "he2rna", "vit"):
        d = root / f"{model_type}_resnet" / "syn"
        os.makedirs(d)
        for fold in range(2):
            if model_type == "vis":
                cfg = jvis.ViSConfig(num_outputs=5, input_dim=DIM, depth=1, nheads=2, dim_f=4,
                                     dim_s=4, dim_c=4, num_clusters=100)
                sd = jconvert.vis_to_torch(cfg, jvis.init(cfg, jax.random.PRNGKey(fold)))
                name = "model_best.pt" if fold == 0 else f"model_best_{fold}.pt"
            elif model_type == "he2rna":
                cfg = jhe.HE2RNAConfig(input_dim=DIM, output_dim=5, layers=(8,), ks=(1, 2))
                sd = jconvert.he2rna_to_torch(cfg, jhe.init(cfg, jax.random.PRNGKey(fold)))
                name = f"model_{fold}.pt"
            else:
                cfg = jvit.ViTConfig(num_outputs=5, dim=DIM, depth=1, heads=1, dim_head=12,
                                     mlp_dim=8)
                sd = jconvert.vit_to_torch(cfg, jvit.init(cfg, jax.random.PRNGKey(fold)))
                name = f"model_best_{fold}.pt"
            checkpoint.save_torch_state_dict(sd, str(d / name))
        with open(d / "test_results.pkl", "wb") as f:
            pickle.dump({"genes": genes}, f)
    return root


@pytest.mark.parametrize("model_type", ["vis", "he2rna", "vit"])
def test_cli_visualize_matches_jax(model_type, workspace, monkeypatch, capsys):
    monkeypatch.chdir(workspace)
    monkeypatch.setattr(jviz, "load_extractor", lambda *a, **kw: pool_features)
    monkeypatch.setattr(tserve, "load_extractor", lambda *a, **kw: PoolExtractor())
    args = ["--study", "syn", "--project", PROJECT, "--gene_names", "G1,G3",
            "--wsi_file_name", WSI, "--model_type", model_type, "--feat_type", "resnet",
            "--folds", "0,1", "--stride", "4", "--patch_size", "64", "--weights", "random",
            "--batch_size", "32"]
    jviz.main([*args, "--save_folder", "jax"])
    res = tviz.main([*args, "--save_folder", "port", "--device", "cpu"])
    assert "visualize: cpu, kernels: none (plain PyTorch)" in capsys.readouterr().err
    got = pd.read_csv(f"visualizations/{PROJECT}/port/{WSI}/stride-4.csv", index_col=0)
    want = pd.read_csv(f"visualizations/{PROJECT}/jax/{WSI}/stride-4.csv", index_col=0)
    for col in ("G1_0", "G1_1", "G1", "G3_0", "G3_1", "G3"):
        assert col in got.columns
    _assert_same_map(got, want)
    assert len(res) == len(got)
    if model_type == "vis":  # device sums against the host's
        tviz.main([*args, "--save_folder", "dev", "--device", "cpu", "--accumulate", "device"])
        dev = pd.read_csv(f"visualizations/{PROJECT}/dev/{WSI}/stride-4.csv", index_col=0)
        _assert_same_map(dev, got)


def test_cli_visualize_data_parallel_matches_jax(workspace, monkeypatch):
    """``--data_parallel``: the windows split over a (2, 1) mesh of the
    extractor's (two CPU "devices"; JAX's two virtual devices) with device
    sums, the map equal to JAX's sharded map and to the port's unsharded
    device map; JAX's refusals for other fold types and ``--accumulate
    host``."""
    from sequoia_tpu.parallel import sharding as jsh
    from sequoia_tpu_torch.parallel import sharding as sh

    class JMeshPool:
        mesh = jsh.make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])

        def __call__(self, tiles):
            return pool_features(tiles)

    class MeshPool(PoolExtractor):
        mesh = sh.make_mesh(2, 1, devices=["cpu", "cpu"])

    monkeypatch.chdir(workspace)
    monkeypatch.setattr(jviz, "load_extractor", lambda *a, **kw: JMeshPool())
    seen = []
    monkeypatch.setattr(tserve, "load_extractor",
                        lambda *a, **kw: seen.append(a[4]) or MeshPool())
    args = ["--study", "syn", "--project", PROJECT, "--gene_names", "G1,G3",
            "--wsi_file_name", WSI, "--model_type", "vis", "--feat_type", "resnet",
            "--folds", "0,1", "--stride", "4", "--patch_size", "64", "--weights", "random",
            "--batch_size", "32", "--data_parallel"]
    jviz.main([*args, "--save_folder", "jax_dp"])
    tviz.main([*args, "--save_folder", "port_dp", "--device", "cpu"])
    assert seen == [True]
    got = pd.read_csv(f"visualizations/{PROJECT}/port_dp/{WSI}/stride-4.csv", index_col=0)
    _assert_same_map(got, pd.read_csv(f"visualizations/{PROJECT}/jax_dp/{WSI}/stride-4.csv",
                                      index_col=0))
    tviz.main([*args[:-1], "--save_folder", "port_one", "--device", "cpu", "--accumulate",
               "device"])
    _assert_same_map(got, pd.read_csv(f"visualizations/{PROJECT}/port_one/{WSI}/stride-4.csv",
                                      index_col=0))
    for extra, msg in ((["--accumulate", "host"], "device accumulation"),):
        with pytest.raises(SystemExit, match=msg):
            tviz.main([*args, *extra, "--save_folder", "x", "--device", "cpu"])
    with pytest.raises(SystemExit, match="vis fold"):
        tviz.main([*[a if a != "vis" else "he2rna" for a in args], "--save_folder", "x",
                   "--device", "cpu"])
    mixed = workspace / "mixed"
    for fold, heads in ((0, 2), (1, 1)):
        cfg = jvis.ViSConfig(num_outputs=5, input_dim=DIM, depth=1, nheads=heads, dim_f=4,
                             dim_s=4, dim_c=4, num_clusters=100)
        checkpoint.save_torch_state_dict(jconvert.vis_to_torch(cfg, jvis.init(
            cfg, jax.random.PRNGKey(fold))), str(mixed / f"model_best_{fold}.pt"))
    with pytest.raises(SystemExit, match="homogeneous vis folds"):
        tviz.load_fold_predictors(str(mixed), [0, 1], "vis", torch.device("cpu"),
                                  mesh=MeshPool.mesh)


def test_resolve_paths_layouts_match_jax(tmp_path):
    """spatial_GBM_pred (spot diameter -> manual resize) and Breast-ST
    (metadata magnification) resolve as in JAX."""
    os.makedirs(tmp_path / "Spatial_GBM" / "masks")
    os.makedirs(tmp_path / "Spatial_Heiland" / "data" / "classify")
    np.save(tmp_path / "Spatial_GBM" / "masks" / "HRI_7_T.npy", np.ones((4, 4), bool))
    pd.DataFrame({"slide_id": ["7_T"], "pixel_diameter": [88.0]}).to_csv(
        tmp_path / "Spatial_Heiland" / "data" / "classify" / "spot_diameter.csv", index=False)
    for d in ("masks", "metadata"):
        os.makedirs(tmp_path / "Breast-ST" / d)
    np.save(tmp_path / "Breast-ST" / "masks" / "BC1.npy", np.zeros((3, 2), bool))
    with open(tmp_path / "Breast-ST" / "metadata" / "BC1.json", "w") as f:
        json.dump({"magnification": "40x"}, f)
    base = ["--study", "s", "--save_folder", "f", "--model_type", "vis", "--feat_type",
            "resnet", "--weights", "random", "--data_root", str(tmp_path)]
    for project, wsi in (("spatial_GBM_pred", "HRI_7_T.tif"), ("Breast-ST", "BC1.tif")):
        argv = [*base, "--project", project, "--wsi_file_name", wsi]
        got = tviz.resolve_paths(tviz.build_parser().parse_args(argv))
        want = jviz.resolve_paths(jviz.build_parser().parse_args(argv))
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(SystemExit, match="unknown project layout"):
        tviz.resolve_paths(tviz.build_parser().parse_args(
            [*base, "--project", "other", "--wsi_file_name", "x.tif"]))


def test_extractor_route_resizes_like_pillow():
    """``featurize_tiles`` with a port ``FeatureExtractor`` on a slide read at
    twice the patch size: the tiles are resized with the bit-exact Pillow
    resize on the extractor's device, then featurised in batches."""
    from PIL import Image

    from sequoia_tpu_torch.data.wsi import ArrayReader, read_regions
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor

    j = synthetic_wsi(w=1024, h=768)
    slide = ArrayReader(j.levels, properties={"aperio.AppMag": "40"})
    df = pd.DataFrame({"xcoord": [0, 128, 256, 384, 512], "ycoord": [256, 256, 384, 384, 128]})
    params = resnet.random_params(torch.Generator().manual_seed(0))
    params.update({f"layer{s}": params[f"layer{s}"][:1] for s in range(1, 5)})
    ext = FeatureExtractor("resnet", params, batch_size=4, patch_size=64, device="cpu",
                           cfg=resnet.ResNetConfig(blocks_per_stage=(1, 1, 1, 1)))
    got = spatial.featurize_tiles(slide, df, 128, ext, resize_to=64, decode_chunk=3)
    tiles = read_regions(slide, list(zip(df["xcoord"], df["ycoord"])), 0, (128, 128))
    pil = np.stack([np.asarray(Image.fromarray(t).resize((64, 64), Image.BILINEAR))
                    for t in tiles])
    assert got.shape == (5, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, ext(pil), rtol=1e-5, atol=1e-5)
