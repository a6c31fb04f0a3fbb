"""The offline chain through both packages' CLIs on one synthetic workspace:
patch_gen -> compute_features -> kmean_features -> main -> evaluate_model,
each package on its own chain's files.  The inputs that decide a stage are
shared: the slides, one fabricated ResNet-50 state dict as a ``.pt``
(``--weights`` of both ``compute_features``) and ``--backend sklearn`` on
both ``kmean_features``.  What each stage writes is held against the JAX
chain's file: the patches equal, the features within the extractor's
tolerance (tests/test_torch_serve_wsi.py), the cluster features within
1e-4 of the table's largest value (the same clusters: a relabelled patch
would move a mean by a whole feature's share).  ``main`` draws its fold initialisation from JAX's PRNG on one side
and a ``torch.Generator`` on the other and takes no initial state, so its
file contract is held instead (``test_results.pkl``'s keys, shapes and
genes, the same patients in each fold's split); then both packages'
``evaluate_model`` on the port's ``test_results.pkl`` write equal tables.

Four slides: with ``--k 2`` each fold's training patients give up one to
the validation carve-out (``valid_size`` 0.1), so a fold needs two."""

import os
import pickle

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)

from sequoia_tpu.cli import compute_features as jcf
from sequoia_tpu.cli import evaluate_model as jev
from sequoia_tpu.cli import kmean_features as jkm
from sequoia_tpu.cli import main as jmain
from sequoia_tpu.cli import patch_gen as jpg
from sequoia_tpu_torch import native
from sequoia_tpu_torch.cli import compute_features as tcf
from sequoia_tpu_torch.cli import evaluate_model as tev
from sequoia_tpu_torch.cli import kmean_features as tkm
from sequoia_tpu_torch.cli import main as tmain
from sequoia_tpu_torch.cli import patch_gen as tpg
from tests.test_pipeline_e2e import synthetic_wsi
from tests.torch_goldens import resnet50_sd

SLIDES, PS, CAP, K, GENES, PROJECT = 4, 64, 16, 4, 6, "TCGA-SYN"
# the extractor's f32 tolerance (tests/test_torch_serve_wsi.py)
FEAT_RTOL, FEAT_ATOL, CLUSTER_REL = 2e-4, 1e-2, 1e-4
CLIS = {"jax": (jpg, jcf, jkm, jmain), "port": (tpg, tcf, tkm, tmain)}


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    wsi = root / "HE"
    os.makedirs(wsi)
    rows = []
    rng = np.random.default_rng(0)
    for i in range(SLIDES):
        stem = f"{PROJECT}-{i:04d}"
        levels = synthetic_wsi(w=512, h=384, seed=i).levels
        if native.available():
            native.write_tiled_tiff(str(wsi / f"{stem}.tiff"), levels, tile=(128, 128))
        else:
            from PIL import Image

            Image.fromarray(levels[0]).save(str(wsi / f"{stem}.tiff"), save_all=True,
                                            append_images=[Image.fromarray(levels[1])])
        rows.append({"wsi_file_name": f"{stem}.svs", "patient_id": f"P{i}",
                     "tcga_project": PROJECT,
                     **{f"rna_G{g}": float(rng.normal()) for g in range(GENES)}})
    ref = root / "ref.csv"
    pd.DataFrame(rows).to_csv(ref, index=False)
    weights = root / "resnet50.pt"
    torch.save({k: v.float() for k, v in resnet50_sd(torch.Generator().manual_seed(0)).items()},
               weights)
    for name, (pg, cf, km, main) in CLIS.items():
        out = root / name
        dev = ["--device", "cpu"] if name == "port" else []
        pg.main(["--wsi_path", str(wsi), "--patch_path", str(out / "patches"),
                 "--mask_path", str(out / "masks"), "--patch_size", str(PS),
                 "--max_patches_per_slide", str(CAP), *dev])
        cf.main(["--ref_file", str(ref), "--patch_data_path", str(out / "patches"),
                 "--feature_path", str(out / "features"), "--weights", str(weights),
                 "--batch_size", str(CAP), "--max_patch_number", str(CAP), *dev])
        km.main(["--ref_file", str(ref), "--feature_path", str(out / "features"),
                 "--num_clusters", str(K), "--backend", "sklearn", *dev])
        main.main(["--ref_file", str(ref), "--feature_path", str(out / "features"),
                   "--model_type", "vis", "--depth", "1", "--num-heads", "2", "--k", "2",
                   "--batch_size", "2", "--num_epochs", "1", "--train",
                   "--save_dir", str(out / "exp"), "--cohort", "syn", "--exp_name", "demo",
                   *dev])
    return root


def _stems():
    return [f"{PROJECT}-{i:04d}" for i in range(SLIDES)]


def _store(root, name, stem, key):
    with h5py.File(root / name / "features" / PROJECT / stem / f"{stem}.h5", "r") as f:
        return f[key][:]


def test_patches_equal(chains):
    for stem in _stems():
        tiles = {}
        for name in CLIS:
            with h5py.File(chains / name / "patches" / stem / f"{stem}.hdf5", "r") as f:
                tiles[name] = {k: f[k][:] for k in f}
            np.testing.assert_array_equal(
                np.load(chains / name / "masks" / stem / "mask.npy"),
                np.load(chains / "jax" / "masks" / stem / "mask.npy"))
        assert sorted(tiles["port"]) == sorted(tiles["jax"]) and len(tiles["jax"]) == CAP
        for k, v in tiles["jax"].items():
            np.testing.assert_array_equal(tiles["port"][k], v)


def test_features_and_cluster_features(chains):
    for stem in _stems():
        want = _store(chains, "jax", stem, "resnet_features")
        got = _store(chains, "port", stem, "resnet_features")
        assert got.shape == want.shape == (CAP, 2048)
        np.testing.assert_allclose(got, want, rtol=FEAT_RTOL, atol=FEAT_ATOL)
        cw = _store(chains, "jax", stem, "cluster_features")
        cg = _store(chains, "port", stem, "cluster_features")
        assert cg.shape == cw.shape == (K, 2048)
        assert np.abs(cg - cw).max() <= CLUSTER_REL * np.abs(cw).max()


def test_training_file_contract(chains):
    exp = {name: chains / name / "exp" / "syn" / "demo" for name in CLIS}
    res = {}
    for name, d in exp.items():
        with open(d / "test_results.pkl", "rb") as f:
            res[name] = pickle.load(f)
    want, got = res["jax"], res["port"]
    assert sorted(got) == sorted(want) and got["genes"] == want["genes"]
    assert list(want["genes"]) == [f"G{g}" for g in range(GENES)]
    for i in range(2):
        w, g = want[f"split_{i}"], got[f"split_{i}"]
        assert sorted(g) == sorted(w)
        for key in w:
            assert np.shape(g[key]) == np.shape(w[key]), (i, key)
        np.testing.assert_array_equal(g["real"], w["real"])
        np.testing.assert_array_equal(g["wsi_file_name"], w["wsi_file_name"])
        assert np.isfinite(g["preds"]).all()
        for split in ("train", "val", "test"):
            np.testing.assert_array_equal(
                np.load(exp["port"] / f"{split}_{i}.npy", allow_pickle=True),
                np.load(exp["jax"] / f"{split}_{i}.npy", allow_pickle=True))
        assert (exp["port"] / f"model_best_{i}.pt").exists()


def test_evaluate_model_equal_on_the_port_results(chains, tmp_path):
    argv = ["--model_dir", str(chains / "port" / "exp" / "syn"), "--cancers", "demo",
            "--folds", "2"]
    jev.main([*argv, "--save_path", str(tmp_path / "jax")])
    tev.main([*argv, "--save_path", str(tmp_path / "port")])
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.csv"))
    assert files and files == sorted(p.relative_to(tmp_path / "port")
                                     for p in (tmp_path / "port").rglob("*.csv"))
    for rel in files:
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port" / rel),
                                      pd.read_csv(tmp_path / "jax" / rel))
