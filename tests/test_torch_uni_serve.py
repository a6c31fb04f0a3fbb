"""The port's UNI serving path against the JAX package on the CPU:
``SlidePredictor`` with a UNI extractor (from patches, features and a WSI in
the 'rgb' and 'screened' modes, kept counts equal to a ResNet predictor's),
``load_extractor("uni", path)`` from a fabricated local state dict at the
UNI width (1024) and depth 1, and the serve CLI with ``--feat_type uni``;
both packages' clustering shared (tests/test_torch_cli_serve.py)."""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.cli import serve as jcli
from sequoia_tpu.data.wsi import ArrayReader as JReader
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.pipeline.features import FeatureExtractor as JExtractor
from sequoia_tpu.serve import SlidePredictor as JPredictor
from sequoia_tpu_torch.cli import serve as tcli
from sequoia_tpu_torch.cli.compute_features import load_extractor
from sequoia_tpu_torch.data.wsi import ArrayReader
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.models import resnet as tresnet
from sequoia_tpu_torch.models import uni_vit as tuni
from sequoia_tpu_torch.models import vis as tvis
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.serve import SlidePredictor
from sequoia_tpu_torch.train import checkpoint
from tests import torch_goldens as tg
from tests.test_pipeline_e2e import synthetic_wsi
from tests.test_torch_cli_serve import _read, _shared_clustering
from tests.test_torch_uni import _jax_tree, _u8

# 64-px patches into a 32-px ViT, k = 4, 2-fold ViS
K, PS, BATCH, CAP = 4, 64, 8, 24
SERVE = dict(img_size=32, patch_size=16, dim=64, depth=1, heads=4, mlp_dim=64)
VIS = dict(num_outputs=5, input_dim=64, depth=1, nheads=2, dim_f=4, dim_s=4, dim_c=4,
           num_clusters=K)


@pytest.fixture(scope="module")
def predictors():
    jcfg, jp, tcfg, tp = _jax_tree(7, **SERVE)
    vcfg = jvis.ViSConfig(**VIS)
    jfolds = [(vcfg, jvis.init(vcfg, jax.random.PRNGKey(20 + i))) for i in range(2)]
    tfolds = [(tvis.ViSConfig(**VIS), convert.vis_params_from_numpy(
        jax.tree.map(np.asarray, p))) for _, p in jfolds]
    jpred = JPredictor(JExtractor("uni", jax.tree.map(jnp.asarray, jp), batch_size=BATCH,
                                  patch_size=PS, cfg=jcfg), jfolds, n_clusters=K,
                       max_patches=CAP, patch_size=PS)
    text = FeatureExtractor("uni", tp, batch_size=BATCH, patch_size=PS, cfg=tcfg, device="cpu")
    tpred = SlidePredictor(text, tfolds, n_clusters=K, max_patches=CAP, patch_size=PS,
                           device="cpu")
    return jpred, tpred


def test_predictor_from_patches_and_features_matches_jax(predictors, monkeypatch):
    jpred, tpred = predictors
    _shared_clustering(monkeypatch)
    u8 = _u8((13, PS, PS, 3), 11)  # a tail block padded to the batch
    want, got = jpred.predict_patches(u8), tpred.predict_patches(u8)
    assert got.shape == want.shape == (1, 5) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    feats = tpred.extractor(u8)
    assert feats.shape == (13, SERVE["dim"])
    np.testing.assert_allclose(tpred.predict_features(torch.as_tensor(feats)), got,
                               rtol=1e-5, atol=1e-6)


def test_predict_wsi_uni_matches_jax_and_keeps_the_resnet_count(predictors, monkeypatch):
    """From a WSI in the 'rgb' mode (AppMag 20: the fused screen and the
    backbone share each uploaded batch of 64-px candidates, the resize runs
    inside the backbone) and the 'screened' mode (AppMag 40): JAX's
    prediction through shared clustering, and the kept count of a ResNet
    predictor on the same slide, since the screen does not depend on the
    backbone."""
    jpred, tpred = predictors
    _shared_clustering(monkeypatch)
    jslide = synthetic_wsi(w=1024, h=768)
    tslide = ArrayReader([lv.copy() for lv in jslide.levels], properties=dict(jslide.properties))
    before = tpred.io_stats["kept"]
    got, want = tpred.predict_wsi(tslide), jpred.predict_wsi(jslide)
    assert got.shape == want.shape == (1, 5) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    kept = tpred.io_stats["kept"] - before
    assert 0 < kept <= CAP
    rcfg = tvis.ViSConfig(**{**VIS, "input_dim": 2048})
    res = SlidePredictor(
        FeatureExtractor("resnet", tresnet.random_params(torch.Generator().manual_seed(0)),
                         batch_size=BATCH, patch_size=PS, device="cpu"),
        [(rcfg, tvis.init(rcfg, torch.Generator().manual_seed(1)))], n_clusters=K,
        max_patches=CAP, patch_size=PS, device="cpu")
    res.predict_wsi(tslide)
    assert res.io_stats["kept"] == kept

    j40 = JReader(jslide.levels, properties={"aperio.AppMag": "40"})
    t40 = ArrayReader([lv.copy() for lv in jslide.levels], properties={"aperio.AppMag": "40"})
    got40, want40 = tpred.predict_wsi(t40), jpred.predict_wsi(j40)
    assert got40.shape == (1, 5) and np.isfinite(got40).all()
    np.testing.assert_allclose(got40, want40, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# loading UNI weights, and the serve CLI
# ---------------------------------------------------------------------------

GENES = [f"G{i}" for i in range(5)]


@pytest.fixture(scope="module")
def uni_files(tmp_path_factory):
    """A fabricated timm state dict at the UNI width (1024) and depth 1 on
    32-px images, a 2-fold CV dir of 1024-d ViS folds, and a PNG slide."""
    from PIL import Image

    root = tmp_path_factory.mktemp("uni_cli")
    sd = tg.uni_sd(torch.Generator().manual_seed(5), img=32, patch=16, dim=1024, depth=1,
                   heads=16, mlp=64)
    checkpoint.save_torch_state_dict({k: v.float().numpy() for k, v in sd.items()},
                                     str(root / "uni.pt"))
    exp = root / "exp"
    for i in range(2):
        fold = tg.make_torch_sd(torch.Generator().manual_seed(30 + i),
                                tg.vis_shapes(len(GENES), 1024, 1, 2, 4, 4, 4, K))
        checkpoint.save_torch_state_dict({k: v.float().numpy() for k, v in fold.items()},
                                         str(exp / f"model_best_{i}.pt"))
    with open(exp / "test_results.pkl", "wb") as f:
        pickle.dump({"genes": GENES}, f)
    Image.fromarray(synthetic_wsi(w=512, h=384, seed=3).levels[0]).save(root / "slide.png")
    return root


def test_load_extractor_uni_from_a_local_state_dict(uni_files):
    """The config comes from the state dict (1024 wide: 16 heads), the
    compute dtype is applied to it, and the weights are the loader's, cast
    once to bf16 on the extractor."""
    path = str(uni_files / "uni.pt")
    ext = load_extractor("uni", path, 4, "bfloat16", device="cpu")
    cfg, want = tuni.uni_from_torch(checkpoint.load_torch_checkpoint(path))
    assert ext.cfg == dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    assert (ext.cfg.dim, ext.cfg.depth, ext.cfg.heads, ext.cfg.img_size) == (1024, 1, 16, 32)
    assert ext.feature_dim == 1024 and ext.feat_type == "uni" and ext.batch_size == 4
    assert ext.params["blocks"]["w_qkv"].dtype == torch.bfloat16
    assert torch.equal(ext.params["blocks"]["w_qkv"], want["blocks"]["w_qkv"].bfloat16())
    f32 = load_extractor("uni", path, 4, device="cpu")
    assert f32.cfg.compute_dtype == torch.float32
    assert torch.equal(f32.params["patch_w"], want["patch_w"])


def test_cli_serves_uni_as_jax(uni_files, monkeypatch):
    """``--feat_type uni`` through both CLIs on the same files, clustering
    shared: the same CSV within rtol 1e-3 / atol 1e-4
    (tests/test_torch_cli_serve.py)."""
    monkeypatch.chdir(uni_files)
    _shared_clustering(monkeypatch)
    args = ["--wsi", "slide.png", "--checkpoints", str(uni_files / "exp"), "--feat_type", "uni",
            "--weights", "uni.pt", "--batch_size", str(BATCH), "--compute_dtype", "float32",
            "--max_patches", str(CAP), "--patch_size", str(PS), "--num_clusters", str(K)]
    jcli.main([*args, "--out", "jax.csv"])
    out = tcli.main([*args, "--device", "cpu", "--out", "port.csv"])
    assert out["slides"] == 1 and out["failed"] == 0
    port, want = _read("port.csv"), _read("jax.csv")
    assert port[0] == want[0] == ["wsi_file_name", *GENES] and port[1] == ["slide.png"]
    assert np.isfinite(port[2]).all()
    np.testing.assert_allclose(port[2], want[2], rtol=1e-3, atol=1e-4)
    pred, line = tcli.build_predictor("uni", "uni.pt", tcli.load_fold_models("exp"),
                                      device="cpu", batch_size=4)
    assert pred.extractor.feat_type == "uni" and "none (plain PyTorch)" in line
    # a 2048-d ResNet extractor against the 1024-d folds stops, naming both
    with pytest.raises(SystemExit, match="2048-d features but the checkpoint expects "
                                         "input_dim 1024"):
        tcli.main(["--wsi", "slide.png", "--checkpoints", "exp", "--weights", "random",
                   "--num_clusters", str(K), "--device", "cpu"])
