"""Serving ViT and HE2RNA folds with the port against the JAX package on the
CPU: ``SlidePredictor(model_type="vit"|"he2rna").predict_cluster_features``
(the fold mean, HE2RNA's predict-time ReLU), the HE2RNA ks clamp and its
all-exceed error, ``cli.serve --model_type vit|he2rna`` on CV directories
against the JAX CLI (clustering shared, a one-block-per-stage ResNet in both
so the JAX side compiles quickly; values within rtol 1e-3 / atol 1e-4 as
tests/test_torch_cli_serve.py), the panel against the full head, and K1
refused for folds that have no ViS blocks."""

import csv
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.cli import serve as jcli
from sequoia_tpu.models import convert as jconvert
from sequoia_tpu.models import he2rna as jhe
from sequoia_tpu.models import resnet as jresnet
from sequoia_tpu.models import vit as jvit
from sequoia_tpu.ops import kmeans as jkm
from sequoia_tpu.pipeline.features import FeatureExtractor as JExtractor
from sequoia_tpu.serve import SlidePredictor as JPredictor
from sequoia_tpu_torch import http_serve as thttp
from sequoia_tpu_torch.cli import serve as tcli
from sequoia_tpu_torch.models import convert, he2rna, vit
from sequoia_tpu_torch.models import resnet as tresnet
from sequoia_tpu_torch.ops import kmeans as tkm
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.serve import SlidePredictor
from sequoia_tpu_torch.train import checkpoint
from tests.test_pipeline_e2e import synthetic_wsi
from tests.test_torch_serve_wsi import _to_jax

K, PS, BATCH, CAP, G = 8, 64, 16, 48, 6
GENES = [f"G{i}" for i in range(G)]
COMMON = ["--batch_size", str(BATCH), "--compute_dtype", "float32", "--max_patches", str(CAP),
          "--patch_size", str(PS), "--num_clusters", str(K), "--weights", "random"]
VIT = dict(num_outputs=G, dim=2048, depth=1, heads=2, dim_head=64, mlp_dim=16, num_clusters=K)
HE = dict(input_dim=2048, output_dim=G, layers=(16,), ks=(1, 2, 5, 10, 20, 50, 100))


def _jax_folds(model_type, n=2):
    if model_type == "vit":
        cfg = jvit.ViTConfig(**VIT)
        return [(cfg, jvit.init(cfg, jax.random.PRNGKey(i))) for i in range(n)]
    cfg = jhe.HE2RNAConfig(**HE)
    return [(cfg, jhe.init(cfg, jax.random.PRNGKey(i))) for i in range(n)]


def _to_torch_sd(model_type, cfg, p):
    to = jconvert.vit_to_torch if model_type == "vit" else jconvert.he2rna_to_torch
    return to(cfg, p)


@pytest.mark.parametrize("model_type", ["vit", "he2rna"])
def test_predict_cluster_features_matches_jax(model_type, capsys):
    jfolds = _jax_folds(model_type)
    jpred = JPredictor(None, jfolds, model_type=model_type, n_clusters=K)
    # the same weights through the port's converters, as a CV dir holds them
    from_torch = convert.vit_from_torch if model_type == "vit" else convert.he2rna_from_torch
    tfolds = [from_torch(_to_torch_sd(model_type, c, p)) for c, p in jfolds]
    tpred = SlidePredictor(None, tfolds, model_type=model_type, n_clusters=K, device="cpu")
    cf = np.abs(np.random.default_rng(0).normal(size=(3, K, 2048))).astype(np.float32)
    cf[1, 5:] = 0.0
    want = jpred.predict_cluster_features(cf)
    got = tpred.predict_cluster_features(cf)
    assert got.shape == want.shape == (3, G)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    one = tpred.predict_cluster_features(cf[0])
    np.testing.assert_allclose(one, got[:1], rtol=1e-5, atol=1e-6)
    if model_type == "he2rna":
        assert (got >= 0).all()
        assert tpred.vis_models[0][0].ks == jpred.vis_models[0][0].ks == (1, 2, 5)
        err = capsys.readouterr().err
        assert "clamping ks (1, 2, 5, 10, 20, 50, 100) -> (1, 2, 5) (n_clusters=8)" in err
        # the fold mean of each fold's ReLU'd eval forward
        x = torch.from_numpy(cf)
        folds = [torch.relu(he2rna.apply(c, p, x)) for c, p in tpred.vis_models]
        np.testing.assert_allclose(got, torch.stack(folds).mean(0).numpy(), rtol=1e-6)


def test_ks_clamp_all_exceed_raises():
    cfg = he2rna.HE2RNAConfig(input_dim=16, output_dim=3, layers=(8,), ks=(20, 50))
    params = he2rna.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="all exceed n_clusters=8"):
        SlidePredictor(None, [(cfg, params)], model_type="he2rna", n_clusters=8, device="cpu")
    jcfg = jhe.HE2RNAConfig(input_dim=16, output_dim=3, layers=(8,), ks=(20, 50))
    with pytest.raises(ValueError, match="all exceed n_clusters=8"):
        JPredictor(None, [(jcfg, jhe.init(jcfg, jax.random.PRNGKey(0)))],
                   model_type="he2rna", n_clusters=8)
    with pytest.raises(ValueError, match="model_type"):
        SlidePredictor(None, [], model_type="mlp", device="cpu")


def test_k1_refused_for_folds_without_vis_blocks():
    vcfg = vit.ViTConfig(**VIT)
    vp = vit.init(vcfg, torch.Generator().manual_seed(0))
    for model_type in ("vit", "he2rna"):
        with pytest.raises(ValueError, match="use_fused_vis"):
            SlidePredictor(None, [(vcfg, vp)], model_type=model_type, use_fused_vis=True,
                           device="cpu")
    on, why = tcli.serving_kernels("cuda", [(vcfg, vp)], model_type="vit")
    assert on == ["bottleneck_chain", "lloyd_stats"] and why == "vit folds have no ViS blocks"
    on, why = tcli.serving_kernels("cuda", [], model_type="he2rna")
    assert on == ["bottleneck_chain", "lloyd_stats"] and "he2rna" in why
    assert tcli.serving_kernels("cpu", [], model_type="he2rna") == ([], "")
    pred, line = tcli.build_predictor("resnet", "random", [(vcfg, vp)], device="cpu",
                                      batch_size=4, model_type="vit")
    assert pred.model_type == "vit" and pred._packed is None and "none" in line


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two ViT and two HE2RNA folds as CV directories (``model_best_{i}.pt``
    / ``model_{i}.pt`` with ``test_results.pkl``) and a tiled TIFF slide."""
    from sequoia_tpu_torch import native

    root = tmp_path_factory.mktemp("serve_models")
    for model_type, name in (("vit", "model_best_{}.pt"), ("he2rna", "model_{}.pt")):
        d = root / model_type
        for i, (c, p) in enumerate(_jax_folds(model_type)):
            checkpoint.save_torch_state_dict(_to_torch_sd(model_type, c, p),
                                             str(d / name.format(i)))
        with open(d / "test_results.pkl", "wb") as f:
            pickle.dump({"genes": GENES}, f)
    slide = synthetic_wsi(w=1024, h=768)
    native.write_tiled_tiff(str(root / "slide1.tiff"), slide.levels, tile=(128, 128))
    return root


def _small_backbones(monkeypatch):
    """Both CLIs' ``load_extractor`` -> one ResNet-50 with one block a
    stage, the same random weights on both sides; both clusterings -> the
    host hybrid k-means from seed 0 (their device k-means draw apart)."""
    tres = tresnet.random_params(torch.Generator().manual_seed(0))
    tres.update({f"layer{s}": tres[f"layer{s}"][:1] for s in range(1, 5)})
    jres = jresnet.enable_s2d_stem(_to_jax(tres))
    blocks = (1, 1, 1, 1)

    def jload(feat_type, weights, batch_size, compute_dtype="float32", data_parallel=False):
        return JExtractor("resnet", jres, batch_size=batch_size,
                          cfg=jresnet.ResNetConfig(blocks_per_stage=blocks))

    def tload(feat_type, weights, batch_size, compute_dtype="float32", data_parallel=False,
              *, device=None, fused_stages=()):
        cfg = tresnet.ResNetConfig(blocks_per_stage=blocks, fused_stages=tuple(fused_stages))
        return FeatureExtractor("resnet", tres, batch_size=batch_size, cfg=cfg, device=device)

    def jcluster(self, feats):
        cf = jkm.kmeans_cluster_features(np.asarray(feats), self.n_clusters, seed=0,
                                         backend="hybrid")
        return jnp.asarray(np.nan_to_num(cf))

    def tcluster(self, feats):
        cf = tkm.kmeans_cluster_features(feats.cpu().numpy(), self.n_clusters, seed=0,
                                         backend="hybrid", device="cpu")
        return torch.as_tensor(np.nan_to_num(cf))

    monkeypatch.setattr(jcli, "load_extractor", jload)
    monkeypatch.setattr(tcli, "load_extractor", tload)
    monkeypatch.setattr(JPredictor, "cluster", jcluster)
    monkeypatch.setattr(SlidePredictor, "cluster", tcluster)


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.asarray([[float(v) for v in r[1:]]
                                                          for r in rows[1:]])


@pytest.mark.parametrize("model_type", ["vit", "he2rna"])
def test_cli_serves_model_type_like_jax(model_type, files, monkeypatch, capsys):
    _small_backbones(monkeypatch)
    monkeypatch.chdir(files)
    args = ["--wsi", "slide1.tiff", "--checkpoints", str(files / model_type),
            "--model_type", model_type, *COMMON]
    jcli.main([*args, "--out", "jax.csv"])
    got = tcli.main([*args, "--device", "cpu", "--out", "port.csv"])
    assert got["slides"] == 1 and got["failed"] == 0
    port, want = _read("port.csv"), _read("jax.csv")
    assert port[0] == want[0] == ["wsi_file_name", *GENES] and port[1] == ["slide1.tiff"]
    assert port[2].shape == (1, G) and np.isfinite(port[2]).all()
    np.testing.assert_allclose(port[2], want[2], rtol=1e-3, atol=1e-4)
    if model_type == "he2rna":
        assert (port[2] >= 0).all()
    assert "serve: cpu, kernels: none (plain PyTorch)" in capsys.readouterr().err

    tcli.main([*args, "--panel", "G4,G1", "--device", "cpu", "--out", "panel.csv"])
    panel = _read("panel.csv")
    assert panel[0] == ["wsi_file_name", "G4", "G1"]
    np.testing.assert_allclose(panel[2], port[2][:, [4, 1]], rtol=1e-5, atol=1e-6)


def test_cli_model_type_checks(files, monkeypatch, tmp_path):
    monkeypatch.chdir(files)
    loaded = tcli.load_fold_models(str(files / "he2rna"), "he2rna")
    assert len(loaded) == 2 and loaded[0][0].output_dim == G
    vits = tcli.load_fold_models(str(files / "vit"), "vit")
    assert len(vits) == 2 and vits[0][0] == vit.ViTConfig(**VIT)
    one = tcli.load_fold_models(str(files / "he2rna" / "model_1.pt"), "he2rna")
    assert torch.equal(one[0][1]["w"][0], loaded[1][1]["w"][0])
    hf = tmp_path / "hf"
    checkpoint._write_hf_dir(str(hf), {}, {"conv0.weight": np.zeros((2, 3, 1), np.float32)})
    with pytest.raises(SystemExit, match="vis-only"):
        tcli.load_fold_models(str(hf), "he2rna")
    base = ["--wsi", "slide1.tiff", *COMMON, "--device", "cpu"]
    with pytest.raises(SystemExit, match="num_clusters"):
        tcli.main(["--checkpoints", str(files / "vit"), "--model_type", "vit", *base,
                   "--num_clusters", "10"])
    with pytest.raises(SystemExit, match="expects input_dim 16"):
        small = tmp_path / "small"
        cfg = he2rna.HE2RNAConfig(input_dim=16, output_dim=G, layers=(4,), ks=(1,))
        checkpoint.save_torch_state_dict(
            convert.he2rna_to_torch(cfg, he2rna.init(cfg, torch.Generator().manual_seed(0))),
            str(small / "model_0.pt"))
        tcli.main(["--checkpoints", str(small), "--model_type", "he2rna", *base,
                   "--gene_names", ",".join(GENES)])
    # he2rna has no position embedding: any --num_clusters serves
    got = tcli.main(["--checkpoints", str(files / "he2rna"), "--model_type", "he2rna",
                     *base[:-2], "--device", "cpu", "--num_clusters", "6", "--out", "k6.csv"])
    assert got["slides"] == 1 and _read("k6.csv")[2].shape == (1, G)


def test_http_serves_he2rna_folds(files, monkeypatch):
    """``http_serve`` over an HE2RNA predictor, unchanged: one POST gives the
    slide's row of the in-process predictor."""
    import json
    import threading
    import urllib.request

    _small_backbones(monkeypatch)
    models = tcli.load_fold_models(str(files / "he2rna"), "he2rna")
    pred, _ = tcli.build_predictor("resnet", "random", models, device="cpu", batch_size=BATCH,
                                   n_clusters=K, max_patches=CAP, patch_size=PS,
                                   compute_dtype="float32", model_type="he2rna")
    path = str(files / "slide1.tiff")
    direct = pred.predict_wsi(path)
    srv = thttp.make_server(thttp.PredictorService(pred, GENES), port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(
            "http://127.0.0.1:%d/predict" % srv.server_address[1],
            data=json.dumps({"wsi": path}).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
    assert out["failed"] == {}
    np.testing.assert_allclose([out["predictions"][path][g] for g in GENES], direct[0],
                               rtol=1e-5, atol=1e-6)


def test_vit_folds_take_the_cli_compute_dtype(files):
    """``--compute_dtype`` reaches ViT folds as ViS folds; HE2RNA folds have
    no compute dtype and stay f32."""
    loaded = tcli.load_fold_models(str(files / "vit"), "vit")
    cfg = dataclasses.replace(loaded[0][0], compute_dtype="bfloat16")
    x = torch.randn(1, K, 2048, generator=torch.Generator().manual_seed(0))
    lo = vit.apply(cfg, loaded[0][1], x)
    hi = vit.apply(loaded[0][0], loaded[0][1], x)
    assert lo.dtype == torch.float32
    assert float((lo - hi).abs().max()) <= 5e-2 * float(hi.abs().max())
