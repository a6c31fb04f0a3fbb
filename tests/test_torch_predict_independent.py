"""Port evaluation/predict_independent.py and its CLI against the JAX package
on the CPU: the fold ensemble's ``pred`` frame within 1e-5 (relative to its
max) of JAX's on the same fold checkpoints and store; the random null sized
like the loaded folds (its draws differ by design), finite; a hub prefix
raises instead of downloading."""

import os
import pickle

import numpy as np
import pytest

import jax

from sequoia_tpu.cli import predict_independent as jcli
from sequoia_tpu.evaluation import predict_independent as jpi
from sequoia_tpu.models import convert as jconvert
from sequoia_tpu.models import vis as jvis
from sequoia_tpu_torch.cli import predict_independent as tcli
from sequoia_tpu_torch.evaluation import predict_independent as tpi
from sequoia_tpu_torch.train import checkpoint
from tests.test_data_and_train import make_store


@pytest.fixture(scope="module", params=[100, 8], ids=["100_tokens", "8_tokens"])
def cohort(request, tmp_path_factory):
    tokens = request.param
    root = tmp_path_factory.mktemp(f"indep{tokens}")
    df = make_store(str(root / "features"), n_slides=7, n_genes=4, dim=8, tokens=tokens)
    cfg = jvis.ViSConfig(num_outputs=4, input_dim=8, depth=1, nheads=2, dim_f=4, dim_s=4,
                         dim_c=4, num_clusters=tokens)
    for fold in range(3):
        checkpoint.save_torch_state_dict(
            jconvert.vis_to_torch(cfg, jvis.init(cfg, jax.random.PRNGKey(fold))),
            str(root / f"ckpt_{fold}.pt"))
    return root, df


def test_ensemble_matches_jax(cohort):
    root, df = cohort
    kw = dict(checkpoint_template=str(root / "ckpt_{fold}.pt"), folds=3, depth=1,
              num_heads=2, batch_size=3, verbose=False)
    want = jpi.predict_independent(df, str(root / "features"), str(root / "jax"), **kw)
    got = tpi.predict_independent(df, str(root / "features"), str(root / "port"),
                                  device="cpu", **kw)
    assert got["pred"].shape == want["pred"].shape == (7, 4)
    assert list(got["pred"].columns) == list(want["pred"].columns) == [f"G{i}" for i in range(4)]
    assert list(got["pred"].index) == list(want["pred"].index)
    g, w = got["pred"].to_numpy(), want["pred"].to_numpy()
    assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    r = got["random"]
    assert r.shape == want["random"].shape and list(r.index) == list(want["random"].index)
    assert np.isfinite(r.to_numpy()).all() and np.abs(r.to_numpy() - g).max() > 1e-3
    with open(root / "port" / "test_results.pkl", "rb") as f:
        on_disk = pickle.load(f)
    assert sorted(on_disk) == ["pred", "random"]
    np.testing.assert_array_equal(on_disk["pred"].to_numpy(), g)


def test_cli_matches_jax_cli(cohort, tmp_path):
    root, df = cohort
    ref = tmp_path / "ref.csv"
    df.to_csv(ref, index=False)
    args = ["--ref_file", str(ref), "--feature_path", str(root / "features"), "--folds", "3",
            "--depth", "1", "--num-heads", "2", "--save_dir", str(tmp_path),
            "--checkpoint_template", str(root / "ckpt_{fold}.pt")]
    jcli.main([*args, "--exp_name", "jax"])
    out = tcli.main([*args, "--exp_name", "port", "--device", "cpu"])
    with open(tmp_path / "jax" / "test_results.pkl", "rb") as f:
        want = pickle.load(f)
    assert np.abs(out["pred"].to_numpy() - want["pred"].to_numpy()).max() \
        <= 1e-5 * np.abs(want["pred"].to_numpy()).max()
    assert os.path.exists(tmp_path / "port" / "test_results.pkl")


def test_sources_and_refusals(tmp_path, cohort):
    root, df = cohort
    assert tpi.fold_checkpoint_source("a/ckpt_{fold}.pt", 2) == \
        jpi.fold_checkpoint_source("a/ckpt_{fold}.pt", 2) == "a/ckpt_2.pt"
    assert tpi.fold_checkpoint_source("gevaertlab/sequoia-brca", 1) == \
        jpi.fold_checkpoint_source("gevaertlab/sequoia-brca", 1) == "gevaertlab/sequoia-brca-1"
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        tpi.predict_independent(df, str(root / "features"), str(tmp_path / "o"),
                                checkpoint_template="gevaertlab/sequoia-brca", folds=1,
                                verbose=False, device="cpu")
    ref = tmp_path / "ref.csv"
    df.to_csv(ref, index=False)
    with pytest.raises(SystemExit, match="checkpoint_template or --tcga_project"):
        tcli.main(["--ref_file", str(ref), "--feature_path", str(root / "features"),
                   "--device", "cpu"])
    # a local hub-layout snapshot per fold loads as a directory
    from sequoia_tpu_torch.models import convert

    cfg, params = convert.vis_from_torch(checkpoint.load_torch_checkpoint(
        str(root / "ckpt_0.pt")))
    checkpoint.save_hf_vis_layout(str(tmp_path / "snap-0"), cfg, params)
    out = tpi.predict_independent(df, str(root / "features"), str(tmp_path / "o"),
                                  checkpoint_template=str(tmp_path / "snap"), folds=1,
                                  depth=1, num_heads=2, verbose=False, device="cpu")
    assert out["pred"].shape == (7, 4)
