"""Port cv.run_he2rna_cross_validation, cli.he2rna and pretrain_gtex --model
he2rna against the JAX package on the CPU.  Both CVs start from one shared
init checkpoint on the same store; at max_epochs=0 each fold's model is that
checkpoint, so the splits, slide names and targets must be equal and the
predictions within 1e-5 (relative to their max)."""

import json
import os
import pickle

import numpy as np
import torch

from sequoia_tpu.train import cv as jcv
from sequoia_tpu_torch.cli import he2rna as the2rna
from sequoia_tpu_torch.cli import pretrain_gtex as tpretrain
from sequoia_tpu_torch.models import convert, he2rna
from sequoia_tpu_torch.train import checkpoint as tckpt
from sequoia_tpu_torch.train import cv as tcv
from tests.test_data_and_train import make_store

K, DIM, GENES, TOKENS = 3, 16, 5, 12
KS = (1, 2, 5, 10)


def _store(root, tokens=TOKENS):
    df = make_store(str(root / "f"), n_slides=18, n_genes=GENES, dim=DIM, tokens=tokens,
                    rng=np.random.default_rng(7))
    cfg = he2rna.HE2RNAConfig(input_dim=DIM, output_dim=GENES, layers=(8, 6), ks=KS)
    sd = convert.he2rna_to_torch(cfg, he2rna.init(cfg, torch.Generator().manual_seed(1)))
    sd["__ks__"] = np.asarray(KS)  # the trained sweep, as a whole-module pickle keeps it
    tckpt.save_torch_state_dict(sd, str(root / "init.pt"))
    return df


def test_he2rna_cross_validation_matches_jax(tmp_path):
    df = _store(tmp_path)
    kw = dict(k=K, batch_size=4, lr=1e-3, max_epochs=0, seed=3,
              checkpoint_path=str(tmp_path / "init.pt"), verbose=False)
    want = jcv.run_he2rna_cross_validation(df, str(tmp_path / "f"), str(tmp_path / "jax"), **kw)
    got = tcv.run_he2rna_cross_validation(df, str(tmp_path / "f"), str(tmp_path / "port"),
                                          device="cpu", **kw)
    assert sorted(got) == sorted(want) and got["genes"] == want["genes"]
    for i in range(K):
        w, g = want[f"split_{i}"], got[f"split_{i}"]
        for key in ("wsi_file_name", "tcga_project", "real"):
            np.testing.assert_array_equal(g[key], w[key])
        for key in ("preds", "random"):
            assert g[key].shape == w[key].shape == (len(w["wsi_file_name"]), GENES)
            assert np.abs(g[key] - w[key]).max() <= 1e-5 * np.abs(w[key]).max()
        sd_j = tckpt.load_torch_checkpoint(str(tmp_path / "jax" / f"model_{i}.pt"))
        sd_t = tckpt.load_torch_checkpoint(str(tmp_path / "port" / f"model_{i}.pt"))
        assert list(sd_t) == list(sd_j)
        for k in sd_j:
            np.testing.assert_array_equal(sd_t[k], sd_j[k])
    with open(tmp_path / "port" / "test_results.pkl", "rb") as f:
        assert sorted(pickle.load(f)) == sorted(want)


def test_cli_he2rna_pretrain_and_hf_export(tmp_path, monkeypatch):
    """``pretrain_gtex --model he2rna --quick 1`` at 5 genes, then ``cli.he2rna
    --checkpoint --change_num_genes`` on a 3-gene cohort with ``--hf_export``:
    ``model_{i}.pt``, ``hf_fold_{i}/`` equal to it, ``test_results.pkl``.
    The contract's 100 tokens: a plain state dict carries no ``__ks__``, so
    the fine-tune takes the reference sweep up to k = 100.  The CLI's fits
    run one epoch of the reference's 200."""
    import functools

    df = _store(tmp_path, tokens=100)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcv, "run_he2rna_cross_validation",
                        functools.partial(tcv.run_he2rna_cross_validation, max_epochs=1))
    ref = tmp_path / "gtex.csv"
    df.to_csv(ref, index=False)
    pre = tpretrain.main(["--path_csv", str(ref), "--feature_path", str(tmp_path / "f"),
                          "--model", "he2rna", "--quick", "1", "--batch_size", "8",
                          "--save_dir", str(tmp_path / "pre"), "--exp_name", "q",
                          "--device", "cpu"])
    assert os.path.basename(pre) == "model.pt" and os.path.dirname(pre).endswith("_q")
    sd = tckpt.load_torch_checkpoint(pre)
    cfg = convert.he2rna_config_from_state_dict(sd)
    assert (cfg.input_dim, cfg.layers, cfg.output_dim) == (DIM, (256, 256), GENES)

    tcga = tmp_path / "tcga.csv"
    df.drop(columns=["rna_G3", "rna_G4"]).to_csv(tcga, index=False)
    out = the2rna.main(["--path_csv", str(tcga), "--feature_path", str(tmp_path / "f"),
                        "--k", "2", "--batch_size", "4",
                        "--checkpoint", pre, "--change_num_genes", "--hf_export",
                        "--destfolder", str(tmp_path / "cv"), "--exp_name", "ft",
                        "--device", "cpu"])
    exp = tmp_path / "cv" / "ft"
    assert out["genes"] == ["G0", "G1", "G2"]
    with open(exp / "test_results.pkl", "rb") as f:
        on_disk = pickle.load(f)
    assert sorted(on_disk) == ["genes", "split_0", "split_1"]
    n_test = 0
    for i in range(2):
        s = on_disk[f"split_{i}"]
        n = len(s["wsi_file_name"])
        n_test += n
        for key in ("real", "preds", "random"):
            assert s[key].shape == (n, 3) and np.isfinite(s[key]).all()
        assert (s["preds"] >= 0).all()  # he2rna_predict's ReLU
        best = tckpt.load_torch_checkpoint(str(exp / f"model_{i}.pt"))
        assert best["conv2.weight"].shape == (3, 256, 1)
        with open(exp / f"hf_fold_{i}" / "config.json") as f:
            conf = json.load(f)
        assert conf == {"input_dim": DIM, "output_dim": 3, "layers": [256, 256],
                        "ks": [1, 2, 5, 10, 20, 50, 100], "dropout": 0.5}
        hf = {}
        if (exp / f"hf_fold_{i}" / "model.safetensors").exists():
            from safetensors.numpy import load_file

            hf = load_file(str(exp / f"hf_fold_{i}" / "model.safetensors"))
        else:
            hf = tckpt.load_torch_checkpoint(str(exp / f"hf_fold_{i}" / "pytorch_model.bin"))
        assert sorted(hf) == sorted(k for k in best if k != "__ks__")
        for k in hf:
            np.testing.assert_array_equal(hf[k], best[k])
        # the pretrained hidden layers carried over: one epoch of Adam at lr
        # 1e-3 moves each weight by at most a few steps of lr
        assert np.abs(best["conv0.weight"] - sd["conv0.weight"]).max() < 0.02
    assert n_test == len(df)


def test_hf_export_refuses_without_a_saved_model(tmp_path, monkeypatch):
    """``hf_export`` publishes only a model ``fit`` saved."""
    import pytest

    from sequoia_tpu_torch.train import he2rna_fit

    df = _store(tmp_path)
    monkeypatch.setattr(he2rna_fit, "fit", lambda *a, **kw: kw["save_fn"] and (
        np.zeros((0, GENES)), np.zeros((0, GENES)), np.asarray([]), np.asarray([])))
    with pytest.raises(FileNotFoundError, match="untrained init"):
        tcv.run_he2rna_cross_validation(df, str(tmp_path / "f"), str(tmp_path / "o"), k=2,
                                        max_epochs=0, hf_export=True, verbose=False,
                                        device="cpu")
