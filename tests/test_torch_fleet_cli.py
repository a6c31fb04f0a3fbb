"""The port's stage fleet on the CPU: two OS processes run ``cli.patch_gen``,
``cli.compute_features``, ``cli.kmean_features`` and ``cli.serve`` with
``--multihost`` over one slide directory and ref file (a ``file://`` store
per CLI through ``--coordinator``), and the union of their outputs equals a
single-process run's: the same patch, feature and cluster stores, and the
serve parts' rows are the single CSV's.  ``compute_features`` and ``serve``
also run ``--data_parallel`` (this process's devices: one CPU).  With CUDA
faked, each CLI's rank binds and uses its local rank's GPU."""

import csv
import json
import os
import pickle
import subprocess
import sys

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from sequoia_tpu_torch import native
from sequoia_tpu_torch.models import convert, vis
from sequoia_tpu_torch.train import checkpoint
from tests.test_pipeline_e2e import synthetic_wsi

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SLIDES = ("FLT-0", "FLT-1", "FLT-2")
K, PS, CAP = 2, 64, 6


def _stages(root, out, fleet_for):
    """[cli, argv] of the four stages writing under ``out``."""
    ref = os.path.join(root, "ref.csv")
    return [
        ["patch_gen", ["--wsi_path", os.path.join(root, "wsi"), "--patch_path",
                       os.path.join(out, "patches"), "--mask_path", os.path.join(out, "masks"),
                       "--patch_size", str(PS), "--max_patches_per_slide", str(CAP),
                       "--device", "cpu", *fleet_for("patch_gen")]],
        ["compute_features", ["--ref_file", ref, "--patch_data_path",
                              os.path.join(out, "patches"), "--feature_path",
                              os.path.join(out, "features"), "--weights", "random",
                              "--batch_size", "4", "--device", "cpu", "--data_parallel",
                              *fleet_for("compute_features")]],
        ["kmean_features", ["--ref_file", ref, "--feature_path", os.path.join(out, "features"),
                            "--num_clusters", str(K), "--device", "cpu",
                            *fleet_for("kmean_features")]],
        ["serve", ["--wsi", *(os.path.join(root, "wsi", f"{s}.tiff") for s in SLIDES),
                   "--checkpoints", os.path.join(root, "exp"), "--weights", "random",
                   "--batch_size", "4", "--compute_dtype", "float32", "--max_patches", "8",
                   "--patch_size", str(PS), "--num_clusters", str(K), "--device", "cpu",
                   "--data_parallel", "--out", os.path.join(out, "preds.csv"),
                   *fleet_for("serve")]],
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not native.available():
        pytest.skip(f"the native TIFF writer did not build: {native.build_error()}")
    root = str(tmp_path_factory.mktemp("fleet"))
    os.makedirs(os.path.join(root, "wsi"))
    for i, s in enumerate(SLIDES):
        native.write_tiled_tiff(os.path.join(root, "wsi", f"{s}.tiff"),
                                synthetic_wsi(w=512, h=384, seed=i).levels, tile=(128, 128))
    pd.DataFrame({"wsi_file_name": [f"{s}.tiff" for s in SLIDES], "patient_id": list(SLIDES),
                  "tcga_project": "TCGA-FLT"}).to_csv(os.path.join(root, "ref.csv"),
                                                      index=False)
    cfg = vis.ViSConfig(num_outputs=3, input_dim=2048, depth=1, nheads=2, dim_f=4, dim_s=4,
                        dim_c=4, num_clusters=K)
    checkpoint.save_torch_state_dict(
        convert.vis_to_torch(cfg, vis.init(cfg, torch.Generator().manual_seed(0))),
        os.path.join(root, "exp", "model_best_0.pt"))
    with open(os.path.join(root, "exp", "test_results.pkl"), "wb") as f:
        pickle.dump({"genes": ["A", "B", "C"]}, f)

    def fleet(rank):
        return lambda name: ["--multihost", "--coordinator",
                             "file://" + os.path.join(root, f"store_{name}"),
                             "--num_processes", "2", "--process_id", str(rank)]

    env = {**os.environ, "PYTHONPATH": ROOT}
    worker = os.path.join(HERE, "torch_fleet_worker.py")
    stages = [_stages(root, os.path.join(root, "fleet"), fleet(rank)) for rank in range(2)]
    stages.append(_stages(root, os.path.join(root, "single"), lambda name: []))
    outs = ["", "", ""]
    # stage by stage, each CLI run in a fresh process per rank (as a fleet
    # launches it), the single-process run beside them
    for k in range(len(stages[0])):
        procs = [subprocess.Popen([sys.executable, worker, json.dumps(run[k])],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=env, cwd=root) for run in stages]
        got = []
        for p in procs:
            try:
                got.append(p.communicate(timeout=240)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        for p in procs:
            assert p.returncode == 0, "\n\n".join(got)
        outs = [o + g for o, g in zip(outs, got)]
    return root, outs


def _tree(path):
    """{relative path: file bytes or HDF5 datasets} under ``path``."""
    out = {}
    for d, _, files in os.walk(path):
        for name in files:
            full = os.path.join(d, name)
            rel = os.path.relpath(full, path)
            if name.endswith((".h5", ".hdf5")):
                with h5py.File(full, "r") as f:
                    out[rel] = {k: f[k][:] for k in f.keys()}
            else:
                with open(full, "rb") as f:
                    out[rel] = f.read()
    return out


def test_each_rank_works_its_own_rows(runs):
    _, (out0, out1, single) = runs
    for stage_rows in (("rows [0:2) of 3", "rows [2:3) of 3"),):
        assert out0.count(stage_rows[0]) == 4 and out1.count(stage_rows[1]) == 4
    assert "[multihost]" not in single
    assert "Extracted features for 2 slides" in out0 and "Extracted features for 1 slides" in out1
    for out in (out0, out1):
        assert "features already obtained" not in out


@pytest.mark.parametrize("stage", ["patches", "features"])
def test_union_of_stores_equals_single_process(runs, stage):
    root, _ = runs
    got, want = (_tree(os.path.join(root, r, stage)) for r in ("fleet", "single"))
    assert sorted(got) == sorted(want) and len(want) >= len(SLIDES)
    for rel, w in want.items():
        g = got[rel]
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), rel
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5, err_msg=rel)
        else:
            assert g == w, rel


def test_serve_parts_union_equals_single_csv(runs):
    root, _ = runs

    def rows(path):
        with open(path, newline="") as f:
            r = list(csv.reader(f))
        return r[0], {row[0]: np.asarray(row[1:], float) for row in r[1:]}

    head, want = rows(os.path.join(root, "single", "preds.csv"))
    h0, p0 = rows(os.path.join(root, "fleet", "preds.part0.csv"))
    h1, p1 = rows(os.path.join(root, "fleet", "preds.part1.csv"))
    assert head == h0 == h1 == ["wsi_file_name", "A", "B", "C"]
    assert sorted(p0) == [f"{s}.tiff" for s in SLIDES[:2]] and list(p1) == ["FLT-2.tiff"]
    for name, v in {**p0, **p1}.items():
        np.testing.assert_allclose(v, want[name], rtol=1e-5, atol=1e-6)


class _Stop(Exception):
    """Raised where a CLI hands its device on; carries what it was given."""


def test_each_rank_binds_its_own_gpu(tmp_path, monkeypatch):
    """Under ``--multihost`` with the default ``--device cuda`` each fleet CLI
    binds and uses its local rank's GPU (``LOCAL_RANK``), not ``cuda:0``, and
    ``--data_parallel`` meshes over that GPU alone.  CUDA is faked (4 devices,
    ``set_device`` recorded); the world is one rank over a ``file://`` store."""
    import importlib

    import torch.distributed as dist

    from sequoia_tpu_torch.parallel import multihost as mh
    from sequoia_tpu_torch.parallel import sharding as sh

    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    bound = []
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    ref = tmp_path / "ref.csv"
    pd.DataFrame({"wsi_file_name": ["a.tiff", "b.tiff"], "patient_id": ["a", "b"],
                  "tcga_project": "TCGA-FLT"}).to_csv(ref, index=False)
    os.makedirs(tmp_path / "wsi")
    for s in ("a", "b"):
        (tmp_path / "wsi" / f"{s}.tiff").touch()
    fleet = ["--multihost", "--coordinator", f"file://{tmp_path / 'store'}",
             "--num_processes", "1", "--process_id", "0"]

    def stop(*args, **kw):  # load_extractor takes data_parallel fifth
        dp = kw.get("data_parallel", args[4] if len(args) > 4 else None)
        raise _Stop(kw.get("device"), dp, sh.local_devices("cuda"))

    cfg = vis.ViSConfig(num_outputs=3, input_dim=8, depth=1, nheads=2, dim_f=4, dim_s=4,
                        dim_c=4, num_clusters=K)
    cases = {
        "compute_features": ("load_extractor", None, [
            "--ref_file", str(ref), "--patch_data_path", "p", "--feature_path", "f",
            "--weights", "random", "--data_parallel"]),
        "kmean_features": ("run_kmeans", "kmeans_stage", [
            "--ref_file", str(ref), "--feature_path", "f"]),
        "patch_gen": ("run_patch_gen", "patch_gen", [
            "--wsi_path", str(tmp_path / "wsi"), "--patch_path", "p", "--mask_path", "m"]),
        "serve": ("build_predictor", None, [
            "--wsi", "a.tiff", "b.tiff", "--checkpoints", "c", "--weights", "random",
            "--num_clusters", str(K), "--data_parallel", "--out", str(tmp_path / "o.csv")]),
    }
    try:
        for name, (fn, owner, argv) in cases.items():
            cli = importlib.import_module(f"sequoia_tpu_torch.cli.{name}")
            monkeypatch.setattr(getattr(cli, owner) if owner else cli, fn, stop)
            if name == "serve":
                monkeypatch.setattr(cli, "load_fold_models", lambda *a: [
                    (cfg, vis.init(cfg, torch.Generator().manual_seed(0)))])
                monkeypatch.setattr(cli, "load_gene_names", lambda *a: ["A", "B", "C"])
            with pytest.raises(_Stop) as e:
                cli.main(argv + fleet)
            device, dp, local = e.value.args
            assert device == torch.device("cuda", 3), name
            assert local == [torch.device("cuda", 3)], name
            if name in ("compute_features", "serve"):
                assert dp is True, name
        assert bound == [torch.device("cuda", 3)] and mh.process_count() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
