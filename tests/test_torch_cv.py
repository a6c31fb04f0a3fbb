"""Port train/cv.py and the two training CLIs against the JAX package on the
CPU.  Both cross-validations start from the same fold checkpoints (written
from a JAX init) on the same store: the split files, targets and slide names
must be equal, the predictions within a per-gene |dr| of 1e-3
(docs/PARITY_NOTES.md) and 5e-4 relative, the trained checkpoints within
5e-4."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

from sequoia_tpu.models import convert as jconvert
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.train import cv as jcv
from sequoia_tpu_torch.cli import main as tmain
from sequoia_tpu_torch.cli import pretrain_gtex as tpretrain
from sequoia_tpu_torch.train import checkpoint as tckpt
from sequoia_tpu_torch.train import cv as tcv
from tests.test_data_and_train import make_store

K, DIM, GENES, HEADS, DEPTH = 3, 64, 5, 1, 1


def _pearson_per_gene(a, b):
    a, b = a - a.mean(0), b - b.mean(0)
    return (a * b).sum(0) / np.sqrt((a * a).sum(0) * (b * b).sum(0))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cv")
    df = make_store(str(root / "f"), n_slides=18, n_genes=GENES, dim=DIM, tokens=4)
    ckpt = root / "init"
    # the reference CV's build: 64-wide heads, here one of them over D = 64
    cfg = jvis.ViSConfig(num_outputs=GENES, input_dim=DIM, depth=DEPTH, nheads=HEADS,
                         dim_f=64, dim_s=64, dim_c=64, num_clusters=4)
    for i in range(K):
        sd = jconvert.vis_to_torch(cfg, jvis.init(cfg, jax.random.PRNGKey(10 + i)))
        tckpt.save_torch_state_dict(sd, str(ckpt / f"model_best_{i}.pt"))
    return root, df


def test_cross_validation_matches_jax(cohort):
    root, df = cohort
    kw = dict(model_type="vis", depth=DEPTH, num_heads=HEADS, k=K, batch_size=4, lr=3e-3,
              num_epochs=2, seed=5, do_train=True, checkpoint_path=str(root / "init"),
              verbose=False)
    want = jcv.run_cross_validation(df, str(root / "f"), str(root / "jax"), **kw)
    got = tcv.run_cross_validation(df, str(root / "f"), str(root / "port"), device="cpu", **kw)

    assert sorted(got) == sorted(want) and got["genes"] == want["genes"]
    for i in range(K):
        for name in ("train", "val", "test"):
            np.testing.assert_array_equal(np.load(root / "port" / f"{name}_{i}.npy",
                                                  allow_pickle=True),
                                          np.load(root / "jax" / f"{name}_{i}.npy",
                                                  allow_pickle=True))
        w, g = want[f"split_{i}"], got[f"split_{i}"]
        np.testing.assert_array_equal(g["real"], w["real"])
        np.testing.assert_array_equal(g["wsi_file_name"], w["wsi_file_name"])
        np.testing.assert_array_equal(g["tcga_project"], w["tcga_project"])
        assert g["preds"].shape == w["preds"].shape == g["random"].shape == w["random"].shape
        assert np.abs(g["preds"] - w["preds"]).max() <= 5e-4 * np.abs(w["preds"]).max()
        dr = np.abs(_pearson_per_gene(g["preds"], g["real"])
                    - _pearson_per_gene(w["preds"], w["real"]))
        assert np.nanmax(dr) <= 1e-3
        sd_j = tckpt.load_torch_checkpoint(str(root / "jax" / f"model_best_{i}.pt"))
        sd_t = tckpt.load_torch_checkpoint(str(root / "port" / f"model_best_{i}.pt"))
        assert list(sd_t) == list(sd_j)
        for k in sd_j:
            scale = max(np.abs(sd_j[k]).max(), 1e-8)
            assert np.abs(sd_t[k] - sd_j[k]).max() <= 5e-4 * scale, k
    with open(root / "port" / "test_results.pkl", "rb") as f:
        on_disk = pickle.load(f)
    assert sorted(on_disk) == sorted(want)


def test_cli_main_and_pretrain_gtex_end_to_end(cohort, tmp_path, monkeypatch):
    """GTEx pretraining at 5 genes, then fine-tuning on a 3-gene cohort with
    the head swapped and the folds published as hub directories."""
    root, df = cohort
    monkeypatch.chdir(tmp_path)
    ref = tmp_path / "gtex.csv"
    df.to_csv(ref, index=False)
    pre = tpretrain.main(["--path_csv", str(ref), "--feature_path", str(root / "f"),
                          "--model", "vis", "--quick", "1", "--batch_size", "8",
                          "--save_dir", str(tmp_path / "pre"), "--exp_name", "q",
                          "--device", "cpu"])
    assert os.path.basename(os.path.dirname(pre)).endswith("_q") and os.path.exists(pre)
    sd = tckpt.load_torch_checkpoint(pre)
    assert sd["linear_head.1.weight"].shape == (GENES, DIM)

    tcga = tmp_path / "tcga.csv"
    df.drop(columns=["rna_G3", "rna_G4"]).to_csv(tcga, index=False)
    out = tmain.main(["--ref_file", str(tcga), "--feature_path", str(root / "f"),
                      "--model_type", "vis", "--k", "2", "--batch_size", "4",
                      "--num_epochs", "1", "--train", "--checkpoint", pre,
                      "--change_num_genes", str(GENES), "--hf_export", "--exp_name", "ft",
                      "--device", "cpu"])
    exp = tmp_path / "saved_exp" / "TCGA" / "ft"
    assert out["genes"] == ["G0", "G1", "G2"] and (exp / "test_results.pkl").exists()
    for i in range(2):
        assert out[f"split_{i}"]["preds"].shape[1] == 3
        assert np.isfinite(out[f"split_{i}"]["preds"]).all()
        hf = tckpt.load_hf_vis_state_dict(str(exp / f"hf_fold_{i}"))
        best = tckpt.load_torch_checkpoint(str(exp / f"model_best_{i}.pt"))
        assert hf["linear_head.1.weight"].shape == (3, DIM)
        for k in best:
            np.testing.assert_array_equal(hf[k], best[k])
        # the pretrained weights carried over (a few AdamW steps at lr 1e-3
        # move each by well under 0.05; a fresh draw is N(0, 1))
        assert np.abs(hf["pos_emb1D"] - sd["pos_emb1D"]).max() < 0.05


def test_cli_main_vit_default_and_resume(cohort, tmp_path, monkeypatch):
    root, df = cohort
    monkeypatch.chdir(tmp_path)
    ref = tmp_path / "ref.csv"
    df.to_csv(ref, index=False)
    args = ["--ref_file", str(ref), "--feature_path", str(root / "f"), "--depth", "1",
            "--num-heads", "2", "--k", "2", "--batch_size", "4", "--num_epochs", "2",
            "--train", "--resume", "--moment_dtype", "bfloat16", "--exp_name", "vit",
            "--device", "cpu"]
    assert tmain.build_parser().parse_args(args).model_type == "vit"
    first = tmain.main(args)
    exp = tmp_path / "saved_exp" / "TCGA" / "vit"
    sd = tckpt.load_torch_checkpoint(str(exp / "model_best_0.pt"))
    assert "transformer.layers.0.0.to_qkv.weight" in sd
    state = str(exp / "train_state_0.npz")
    _, ostate, meta = tckpt.load_train_state(state)
    assert meta["epoch"] == 1
    assert all(st["exp_avg"].dtype == torch.bfloat16 for st in ostate["state"].values())
    again = tmain.main(args)  # resumed at epoch 2 of 2: no further training
    _, ostate2, meta2 = tckpt.load_train_state(state)
    assert meta2 == meta
    for i, st in ostate["state"].items():
        assert torch.equal(ostate2["state"][i]["exp_avg"], st["exp_avg"])
    np.testing.assert_array_equal(again["split_0"]["preds"], first["split_0"]["preds"])


@pytest.mark.parametrize("flag", [["--mesh", "data=2"], ["--multihost"],
                                  ["--coordinator", "h:1"], ["--num_processes", "2"],
                                  ["--process_id", "0"]])
def test_cli_main_refuses_multi_gpu_flags(flag):
    """The mesh and fleet flags, once refused at parse time, now parse as
    the JAX CLI's (``--mesh`` runs in tests/test_torch_mesh_cli.py)."""
    from sequoia_tpu.cli import main as jmain

    argv = ["--ref_file", "x.csv", *flag]
    args, jargs = tmain.build_parser().parse_args(argv), jmain.build_parser().parse_args(argv)
    for dest in ("mesh", "multihost", "coordinator", "num_processes", "process_id"):
        assert getattr(args, dest) == getattr(jargs, dest)
    assert tmain.parse_mesh(args.mesh) == ((2, 1) if args.mesh else (None, 1))
