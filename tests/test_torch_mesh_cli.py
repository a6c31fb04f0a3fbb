"""Training over a mesh of gloo ranks on the CPU: ``cli.main --mesh
data=2`` and ``--mesh data=1,model=2`` (the CLI spawns its ranks), and two
OS processes joined by ``--multihost --coordinator file://...
--num_processes 2 --process_id i``, write the single-process CLI's
``test_results.pkl`` (predictions within rtol 1e-4 after two epochs), the
same files, rank 0 alone writing."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from sequoia_tpu_torch.cli import main as tmain
from tests.test_data_and_train import make_store

GENES, DIM = 4, 16


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    df = make_store(str(root / "f"), n_slides=12, n_genes=GENES, dim=DIM, tokens=5)
    df.to_csv(root / "ref.csv", index=False)
    return root, df


def _cli(root, name, *extra):
    return ["--ref_file", str(root / "ref.csv"), "--feature_path", str(root / "f"),
            "--model_type", "vis", "--depth", "1", "--num-heads", "2", "--k", "2",
            "--batch_size", "4", "--num_epochs", "2", "--train", "--exp_name", name,
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def single(store, tmp_path_factory):
    root, _ = store
    out = tmp_path_factory.mktemp("single")
    return tmain.main(_cli(root, "single", "--src_path", str(out))), out


@pytest.mark.parametrize("mesh", ["data=2", "data=1,model=2"])
def test_cli_main_mesh_matches_single_process(store, single, tmp_path, monkeypatch, mesh):
    root, _ = store
    monkeypatch.setattr(tmain, "SPAWN_TIMEOUT", 240.0)  # a hung rank fails the test
    want, out = single
    got = tmain.main(_cli(root, "meshed", "--mesh", mesh, "--src_path", str(tmp_path)))
    exp = tmp_path / "saved_exp" / "TCGA" / "meshed"
    assert sorted(os.listdir(exp)) == sorted(os.listdir(out / "saved_exp" / "TCGA" / "single"))
    with open(exp / "test_results.pkl", "rb") as f:
        assert sorted(pickle.load(f)) == sorted(got) == sorted(want)
    assert got["genes"] == want["genes"]
    for i in range(2):
        w, g = want[f"split_{i}"], got[f"split_{i}"]
        np.testing.assert_array_equal(g["real"], w["real"])
        np.testing.assert_array_equal(g["wsi_file_name"], w["wsi_file_name"])
        np.testing.assert_allclose(g["preds"], w["preds"], rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(g["random"], w["random"])


def test_cli_main_multihost_matches_single_process(store, single, tmp_path):
    root, _ = store
    want, _ = single
    argv = _cli(root, "fleet", "--src_path", str(tmp_path), "--mesh", "data=2",
                "--multihost", "--coordinator", "file://" + str(tmp_path / "store"),
                "--num_processes", "2")
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.dirname(here)}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_fleet_worker.py"),
         json.dumps(["main", [*argv, "--process_id", str(rank)]])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=tmp_path)
        for rank in range(2)]
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0 and "DONE" in out, out
    with open(tmp_path / "saved_exp" / "TCGA" / "fleet" / "test_results.pkl", "rb") as f:
        got = pickle.load(f)
    for i in range(2):
        np.testing.assert_allclose(got[f"split_{i}"]["preds"], want[f"split_{i}"]["preds"],
                                   rtol=1e-4, atol=1e-5)
