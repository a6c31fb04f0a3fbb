"""The k-means stage of the port against the JAX package on the CPU:
``pipeline/kmeans_stage.run_kmeans`` writes ``cluster_features`` equal to
JAX's at 1e-5 with the ``hybrid`` and ``sklearn`` backends, within the
inertia tolerance of tests/test_torch_kmeans.py with ``device`` (JAX's
``tpu``: the two seed from different generators, so the best of four seeds
on each side), writes each slide's own fit, keeps the skip rules (no
``feat_name``, fewer patches than clusters, ``cluster_features`` present
and never overwritten), each row's own project and the GTEx layout;
``kmeans_cluster_features(backend="sklearn")`` equals JAX's and raises an
ImportError without sklearn; ``cli.kmean_features`` gives the JAX CLI's
outputs for the same argv; and ``cli.main``'s feature store reads what the
stage wrote."""

import os
import shutil
import sys

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)

from sequoia_tpu.cli import kmean_features as jcli
from sequoia_tpu.ops import kmeans as jkm
from sequoia_tpu.pipeline import kmeans_stage as jstage
from sequoia_tpu_torch.cli import kmean_features as tcli
from sequoia_tpu_torch.data import dataset as tds
from sequoia_tpu_torch.ops import kmeans as tkm
from sequoia_tpu_torch.pipeline import kmeans_stage as tstage

K = 6


def _blobs(n, d, seed):
    """Separated blobs: any kmeans++ draw finds the same optimum."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(K, d)) * 4
    return (centers[rng.integers(0, K, n)] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _store(path, **datasets):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        for k, v in datasets.items():
            f.create_dataset(k, data=v)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Feature stores under ``{root}/{project}/{wsi}/{wsi}.h5``: two 16-d
    slides in different projects and buckets, an 8-d slide, one below k,
    one without ``resnet_features``, one already clustered, and a GTEx
    slide under its tissue with ``.svs`` kept."""
    root = tmp_path_factory.mktemp("features")
    _store(str(root / "P1" / "A" / "A.h5"), resnet_features=_blobs(90, 16, 0))
    _store(str(root / "P2" / "B" / "B.h5"), resnet_features=_blobs(300, 16, 1))
    _store(str(root / "P2" / "C" / "C.h5"), resnet_features=_blobs(70, 8, 2))
    _store(str(root / "P1" / "D" / "D.h5"), resnet_features=_blobs(K - 1, 16, 3))
    _store(str(root / "P1" / "E" / "E.h5"), uni_features=_blobs(40, 16, 4))
    _store(str(root / "P1" / "F" / "F.h5"), resnet_features=_blobs(40, 16, 5),
           cluster_features=np.full((K, 16), 7.0, np.float32))
    _store(str(root / "Lung" / "G.svs" / "G.svs.h5"), resnet_features=_blobs(50, 16, 6))
    return root


DF = pd.DataFrame({"wsi_file_name": ["A.svs", "B", "A.svs", "C.svs", "D", "E", "F", "M"],
                   "patient_id": list("ABACDEFM"),
                   "tcga_project": ["P1", "P2", "P1", "P2", "P1", "P1", "P1", "P1"]})
CLUSTERED = (("P1", "A"), ("P2", "B"), ("P2", "C"))


def _cf(root, project, wsi):
    with h5py.File(os.path.join(root, project, wsi, f"{wsi}.h5"), "r") as f:
        return f["cluster_features"][:] if "cluster_features" in f else None


def _both(stores, tmp_path, **kw):
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(stores, j)
    shutil.copytree(stores, t)
    jkw = {**kw, "backend": "tpu" if kw.get("backend") == "device" else kw.get("backend")}
    nj = jstage.run_kmeans(DF, j, num_clusters=K, verbose=False, **jkw)
    nt = tstage.run_kmeans(DF, t, num_clusters=K, verbose=False, device="cpu", **kw)
    return nj, nt, j, t


def _inertia(x, means):
    d2 = ((x[:, None, :] - means[None]) ** 2).sum(-1)
    return float(d2.min(1).sum())


@pytest.mark.parametrize("backend", ["hybrid", "sklearn", "device"])
def test_run_kmeans_matches_jax(stores, tmp_path, backend, capsys):
    nj, nt, j, t = _both(stores, tmp_path, backend=backend)
    assert nt == nj == 3
    for project, wsi in CLUSTERED:
        got, want = _cf(t, project, wsi), _cf(j, project, wsi)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        if backend == "device":
            # the packages draw kmeans++ from different generators, and one
            # draw of either can stop in a local minimum (the port's seed 0
            # on slide B does): hold the best fit of seeds 0-3 on each side
            with h5py.File(os.path.join(t, project, wsi, f"{wsi}.h5"), "r") as f:
                x = f["resnet_features"][:]
            x64 = x.astype(np.float64)
            port = [got, *(tkm.kmeans_cluster_features(x, K, s, "device", device="cpu")
                           for s in (1, 2, 3))]
            ref = [want, *(jkm.kmeans_cluster_features(x, K, s, "tpu") for s in (1, 2, 3))]
            np.testing.assert_allclose(min(_inertia(x64, m) for m in port),
                                       min(_inertia(x64, m) for m in ref), rtol=5e-4)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the skips: below k, no feat_name, already clustered (kept as it was)
    assert _cf(t, "P1", "D") is None and _cf(t, "P1", "E") is None
    np.testing.assert_array_equal(_cf(t, "P1", "F"), np.full((K, 16), 7.0, np.float32))
    # a second run clusters nothing and changes nothing
    before = [_cf(t, p, w) for p, w in CLUSTERED]
    assert tstage.run_kmeans(DF, t, num_clusters=K, backend=backend, verbose=True,
                             device="cpu") == 0
    out = capsys.readouterr().out
    assert "A: Cluster feature already available" in out
    assert "D less number of patches than clusters" in out
    assert "Cannot open file" in out and "No resnet_features for" in out
    for (p, w), cf in zip(CLUSTERED, before):
        np.testing.assert_array_equal(_cf(t, p, w), cf)


def test_gtex_layout_and_write_rules(stores, tmp_path, capsys):
    """GTEx mode: the tissue names the directory and .svs stays; the r+
    append refuses to overwrite and reports an unwritable store."""
    gtex = pd.DataFrame({"wsi_file_name": ["G.svs"], "patient_id": ["G"]})
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(stores, j)
    shutil.copytree(stores, t)
    assert jstage.run_kmeans(gtex, j, num_clusters=K, backend="hybrid", gtex_tissue="Lung",
                             verbose=False) == 1
    assert tstage.run_kmeans(gtex, t, num_clusters=K, backend="hybrid", gtex_tissue="Lung",
                             verbose=False, device="cpu") == 1
    np.testing.assert_allclose(_cf(t, "Lung", "G.svs"), _cf(j, "Lung", "G.svs"), rtol=1e-5,
                               atol=1e-5)
    path = os.path.join(t, "Lung", "G.svs", "G.svs.h5")
    assert not tstage._write_cluster_features(path, np.zeros((K, 16), np.float32))
    np.testing.assert_array_equal(_cf(t, "Lung", "G.svs"), _cf(j, "Lung", "G.svs"))
    assert not tstage._write_cluster_features(str(tmp_path / "missing.h5"), np.zeros(2))
    assert "Error writing cluster_features to" in capsys.readouterr().out
    with pytest.raises(ValueError, match="backend"):
        tstage.run_kmeans(gtex, t, backend="tpu", device="cpu")


@pytest.mark.parametrize("backend", ["hybrid", "device"])
def test_run_kmeans_writes_each_slides_own_fit(stores, tmp_path, backend):
    """Each slide's cluster_features is its own fit by kmeans_cluster_features
    with the stage's seed, exactly; K5 mode (its plain version on the CPU)
    writes the same clustering."""
    t = str(tmp_path / "port")
    shutil.copytree(stores, t)
    assert tstage.run_kmeans(DF, t, num_clusters=K, backend=backend, seed=3, verbose=False,
                             device="cpu") == 3
    k5 = str(tmp_path / "k5")
    shutil.copytree(stores, k5)
    assert tstage.run_kmeans(DF, k5, num_clusters=K, backend=backend, seed=3, verbose=False,
                             device="cpu", use_pallas=True) == 3
    for project, wsi in CLUSTERED:
        with h5py.File(os.path.join(t, project, wsi, f"{wsi}.h5"), "r") as f:
            x = f["resnet_features"][:]
        want = tkm.kmeans_cluster_features(x, K, 3, backend, device="cpu")
        np.testing.assert_array_equal(_cf(t, project, wsi), want)
        np.testing.assert_allclose(_inertia(x, _cf(k5, project, wsi)), _inertia(x, want),
                                   rtol=1e-5)


def test_sklearn_backend(monkeypatch):
    x = _blobs(120, 16, 9)
    want = jkm.kmeans_cluster_features(x, K, seed=0, backend="sklearn")
    got = tkm.kmeans_cluster_features(x, K, seed=0, backend="sklearn")
    np.testing.assert_array_equal(got, want)
    # an empty cluster's mean is NaN (duplicate points: fewer distinct than k)
    dup = np.repeat(_blobs(3, 4, 1), 4, axis=0)
    with pytest.warns(Warning):
        got = tkm.kmeans_cluster_features(dup, K, seed=0, backend="sklearn")
    np.testing.assert_array_equal(np.isnan(got).all(1), np.isnan(
        jkm.kmeans_cluster_features(dup, K, seed=0, backend="sklearn")).all(1))
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    with pytest.raises(ImportError, match="backend 'sklearn'"):
        tkm.kmeans_cluster_features(x, K, seed=0, backend="sklearn")
    with pytest.raises(ValueError, match="backend"):
        tkm.kmeans_cluster_features(x, K, backend="tpu", device="cpu")


@pytest.mark.parametrize("backend", ["hybrid", "sklearn"])
def test_cli_matches_jax(stores, tmp_path, backend, capsys):
    ref = tmp_path / "ref.csv"
    DF.to_csv(ref, index=False)
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(stores, j)
    shutil.copytree(stores, t)
    args = ["--ref_file", str(ref), "--num_clusters", str(K), "--backend", backend,
            "--seed", "5", "--tcga_projects", "P1", "P2", "--end", "6"]
    jcli.main([*args, "--feature_path", j])
    got = tcli.main([*args, "--feature_path", t, "--device", "cpu"])
    assert got == {"slides": 3, "kernels": []}
    assert f"kmean_features: cpu, backend {backend}, kernels: none" in capsys.readouterr().err
    for project, wsi in CLUSTERED:
        np.testing.assert_allclose(_cf(t, project, wsi), _cf(j, project, wsi), rtol=1e-5,
                                   atol=1e-5)
    # seeded with 0 whatever --seed says (the reference's random_state=0)
    with h5py.File(os.path.join(t, "P1", "A", "A.h5"), "r") as f:
        x = f["resnet_features"][:]
    np.testing.assert_allclose(_cf(t, "P1", "A"), tkm.kmeans_cluster_features(
        x, K, seed=0, backend=backend, device="cpu"), rtol=1e-6, atol=1e-6)

    # cli.main's feature store reads the stage's cluster_features
    kept = tds.filter_no_features(DF, t, verbose=False)
    assert list(kept["wsi_file_name"]) == ["A.svs", "B", "A.svs", "C.svs", "F"]
    data = tds.FeatureDataset(kept.drop_duplicates("wsi_file_name").iloc[:2], t)
    np.testing.assert_array_equal(data.load_features(0), _cf(t, "P1", "A"))
    assert data.num_tokens == K and data.feature_dim == 16


def test_cli_kernel_set_and_flags(stores, tmp_path, monkeypatch, capsys):
    """On CUDA the Lloyd steps run through K5 unless ``--kernels off`` or the
    sklearn backend, and the device backend's seeding through kmeans_seed;
    ``tpu`` is the JAX name of ``device``; the fleet flags
    parse; without CUDA the CLI raises."""
    ref = tmp_path / "ref.csv"
    DF.iloc[:1].to_csv(ref, index=False)
    seen = []
    monkeypatch.setattr(tcli, "resolve_device", lambda d: torch.device(d or "cuda"))
    monkeypatch.setattr(tcli.kmeans_stage, "run_kmeans",
                        lambda df, path, **kw: seen.append((kw["backend"], kw["use_pallas"],
                                                            kw["seed"])) or 0)
    for extra in ([], ["--kernels", "off"], ["--backend", "sklearn"], ["--backend", "hybrid"],
                  ["--backend", "tpu"]):
        tcli.main(["--ref_file", str(ref), *extra])
    assert seen == [("device", True, 0), ("device", False, 0), ("sklearn", False, 0),
                    ("hybrid", True, 0), ("device", True, 0)]
    err = capsys.readouterr().err.splitlines()
    assert "kmean_features: cuda, backend device, kernels: lloyd_stats, kmeans_seed" in err
    assert "kmean_features: cuda, backend device, kernels: none" in err
    assert "kmean_features: cuda, backend hybrid, kernels: lloyd_stats" in err
    monkeypatch.undo()
    for flag, dest, value in ((["--multihost"], "multihost", True),
                              (["--coordinator", "h:1"], "coordinator", "h:1"),
                              (["--num_processes", "2"], "num_processes", 2),
                              (["--process_id", "1"], "process_id", 1)):
        assert getattr(tcli.build_parser().parse_args(["--ref_file", "x", *flag]),
                       dest) == value
    # the JAX CLI's default backend name is taken as the port's "device"
    assert tcli.build_parser().parse_args(["--ref_file", "x", "--backend", "tpu"]).backend \
        == "tpu"
    jflags = {a.dest for a in jcli.build_parser()._actions}
    tflags = {a.dest for a in tcli.build_parser()._actions}
    assert tflags - jflags == {"device", "kernels"} and jflags <= tflags
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--ref_file", str(ref), "--feature_path", str(stores)])
