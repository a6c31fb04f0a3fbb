"""The feature stage of the port against the JAX package on the CPU:
``pipeline/features.load_patches`` selects the same patches in the same order
from either layout (h5py's byte-wise name order, one ``random.sample``
stream), ``compute_features`` writes the same ``{feat}_features`` (at the
f32 parity tolerance of tests/test_torch_serve_wsi.py), sentinels and
skips, with one ``random.Random`` for the whole ref file, and
``cli.compute_features`` gives the JAX CLI's outputs for the same argv.  Both
sides run a one-block-per-stage ResNet-50 with the same random weights."""

import os
import random as pyrandom

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)

from sequoia_tpu.cli import compute_features as jcli
from sequoia_tpu.models import resnet as jresnet
from sequoia_tpu.pipeline import features as jfeat
from sequoia_tpu_torch.cli import compute_features as tcli
from sequoia_tpu_torch.models import resnet as tresnet
from sequoia_tpu_torch.pipeline import features as tfeat
from tests.test_torch_serve_wsi import _to_jax

PS, BATCH, CAP, SEED = 64, 8, 10, 3
BLOCKS = (1, 1, 1, 1)
# the f32 feature tolerance of tests/test_torch_serve_wsi.py
RTOL, ATOL = 2e-4, 1e-2


def _coords(n, seed):
    """n distinct level-0 coords whose names mix digit counts ("1024_0"
    sorts before "256_0" byte-wise), in a shuffled write order."""
    grid = [(x, y) for x in (0, 64, 256, 1024, 1088, 11264) for y in (0, 64, 512, 2048, 9)]
    order = np.random.default_rng(seed).permutation(len(grid))[:n]
    return [grid[i] for i in order]


def _write(path, patches, coords, layout):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        if layout == "tiles":
            for img, (x, y) in zip(patches, coords):
                f.create_dataset(f"{x}_{y}", data=img)
        else:
            f.create_dataset("patches", data=np.stack(patches), chunks=(8, PS, PS, 3))
            f.create_dataset("coords", data=np.asarray(coords, np.int64))


@pytest.fixture(scope="module")
def patch_root(tmp_path_factory):
    """A-1 in the tiles layout, C-3 the same patches packed (another write
    order), B-2 packed, D-4 tiles below the cap; Q-5 a corrupt file."""
    root = tmp_path_factory.mktemp("patches")
    rng = np.random.default_rng(0)
    a = list(rng.integers(0, 256, (24, PS, PS, 3), dtype=np.uint8))
    ca = _coords(24, 1)
    _write(str(root / "A-1" / "A-1.hdf5"), a, ca, "tiles")
    perm = np.random.default_rng(2).permutation(24)
    _write(str(root / "C-3" / "C-3.hdf5"), [a[i] for i in perm], [ca[i] for i in perm],
           "packed")
    _write(str(root / "B-2" / "B-2.hdf5"),
           list(rng.integers(0, 256, (20, PS, PS, 3), dtype=np.uint8)), _coords(20, 3),
           "packed")
    _write(str(root / "D-4" / "D-4.hdf5"),
           list(rng.integers(0, 256, (6, PS, PS, 3), dtype=np.uint8)), _coords(6, 4), "tiles")
    os.makedirs(root / "Q-5")
    (root / "Q-5" / "Q-5.hdf5").write_bytes(b"not an hdf5 file")
    return root


@pytest.mark.parametrize("cap", [None, CAP])
def test_load_patches_matches_jax_in_both_layouts(patch_root, cap):
    outs = []
    for name in ("A-1", "C-3"):
        path = str(patch_root / name / f"{name}.hdf5")
        want = jfeat.load_patches(path, cap, pyrandom.Random(SEED))
        got = tfeat.load_patches(path, cap, pyrandom.Random(SEED))
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    np.testing.assert_array_equal(outs[1], outs[0])  # tiles and packed select alike
    assert len(outs[0]) == (cap or 24)


@pytest.fixture(scope="module")
def extractors():
    """The same one-block-per-stage ResNet-50 on both sides."""
    tres = tresnet.random_params(torch.Generator().manual_seed(0))
    tres.update({f"layer{s}": tres[f"layer{s}"][:1] for s in range(1, 5)})
    jres = jresnet.enable_s2d_stem(_to_jax(tres))
    jext = jfeat.FeatureExtractor("resnet", jres, batch_size=BATCH, patch_size=PS,
                                  cfg=jresnet.ResNetConfig(blocks_per_stage=BLOCKS))
    text = tfeat.FeatureExtractor("resnet", tres, batch_size=BATCH, patch_size=PS,
                                  cfg=tresnet.ResNetConfig(blocks_per_stage=BLOCKS),
                                  device="cpu")
    return jext, text, tres


def _ref(rows):
    return pd.DataFrame([{"wsi_file_name": w, "patient_id": w[:3], "tcga_project": p}
                         for w, p in rows])


def _read(root, project, wsi):
    with h5py.File(os.path.join(root, project, wsi, f"{wsi}.h5"), "r") as f:
        assert list(f.keys()) == ["resnet_features"]
        return f["resnet_features"][:]


def test_compute_features_matches_jax(patch_root, extractors, tmp_path, capsys):
    jext, text, _ = extractors
    df = _ref([("A-1.svs", "P1"), ("B-2", "P2"), ("A-1.svs", "P1"), ("Z-9.svs", "P1"),
               ("D-4.svs", "P2"), ("Q-5.svs", "P2")])
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(max_patch_number=CAP, seed=SEED, verbose=True)
    assert jfeat.compute_features(df, str(patch_root), j, jext, **kw) == 3
    jout = capsys.readouterr().out
    from sequoia_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    assert tfeat.compute_features(df, str(patch_root), t, text, timer=timer, **kw) == 3
    tout = capsys.readouterr().out
    for project, wsi in (("P1", "A-1"), ("P2", "B-2"), ("P2", "D-4")):
        got, want = _read(t, project, wsi), _read(j, project, wsi)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        sentinel = os.path.join(project, wsi, "complete_tile.txt")
        assert open(os.path.join(t, sentinel)).read() == open(os.path.join(j, sentinel)).read()
    assert _read(t, "P2", "D-4").shape[0] == 6  # below the cap: every patch
    for line in ("Not exist", "Q-5:"):
        assert [ln for ln in tout.splitlines() if ln.startswith(line)] == \
            [ln for ln in jout.splitlines() if ln.startswith(line)] != []
    assert {k: s["items"] for k, s in timer.stages.items()} == {
        "read_patches": 4, "extract": 2 * CAP + 6, "write_features": 3}

    # one random.Random for the whole ref file: B-2's draw follows A-1's
    rng = pyrandom.Random(SEED)
    tfeat.load_patches(str(patch_root / "A-1" / "A-1.hdf5"), CAP, rng)
    b2 = str(patch_root / "B-2" / "B-2.hdf5")
    np.testing.assert_allclose(_read(t, "P2", "B-2"), text(tfeat.load_patches(b2, CAP, rng)),
                               rtol=1e-6, atol=1e-6)
    reseeded = text(tfeat.load_patches(b2, CAP, pyrandom.Random(SEED)))
    assert not np.allclose(_read(t, "P2", "B-2"), reseeded)

    # the sentinels skip: a second run, and a complete_resnet.txt
    assert tfeat.compute_features(df, str(patch_root), t, text, **kw) == 0
    assert "A-1: features already obtained" in capsys.readouterr().out
    os.makedirs(os.path.join(str(tmp_path / "other"), "P1", "A-1"))
    open(os.path.join(str(tmp_path / "other"), "P1", "A-1", "complete_resnet.txt"), "w").close()
    assert tfeat.compute_features(_ref([("A-1.svs", "P1")]), str(patch_root),
                                  str(tmp_path / "other"), text, **kw) == 0


def _small_backbones(monkeypatch, extractors, seen):
    jext, _, tres = extractors

    def jload(feat_type, weights, batch_size, compute_dtype="float32", data_parallel=False):
        return jext

    def tload(feat_type, weights, batch_size, compute_dtype="float32", data_parallel=False,
              *, device=None, fused_stages=()):
        seen.append((feat_type, str(device), tuple(fused_stages)))
        cfg = tresnet.ResNetConfig(blocks_per_stage=BLOCKS)
        return tfeat.FeatureExtractor("resnet", tres, batch_size=batch_size, cfg=cfg,
                                      patch_size=PS, device="cpu")

    monkeypatch.setattr(jcli, "load_extractor", jload)
    monkeypatch.setattr(tcli, "load_extractor", tload)


def test_cli_matches_jax(patch_root, extractors, tmp_path, monkeypatch, capsys):
    seen = []
    _small_backbones(monkeypatch, extractors, seen)
    ref = tmp_path / "ref.csv"
    _ref([("A-1.svs", "P1"), ("B-2", "P2"), ("D-4.svs", "P3"), ("C-3", "P2")]).to_csv(
        ref, index=False)
    args = ["--ref_file", str(ref), "--patch_data_path", str(patch_root), "--weights",
            "random", "--max_patch_number", str(CAP), "--seed", str(SEED), "--batch_size",
            str(BATCH), "--tcga_projects", "P1", "P2", "--end", "3"]
    jcli.main([*args, "--feature_path", str(tmp_path / "jax")])
    got = tcli.main([*args, "--feature_path", str(tmp_path / "port"), "--device", "cpu"])
    assert got["slides"] == 3 and got["kernels"] == []
    assert set(got["stages"]) == {"read_patches", "extract", "write_features"}
    assert "compute_features: cpu, kernels: none (plain PyTorch)" in capsys.readouterr().err
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == ["P1", "P2"]
    for project, wsi in (("P1", "A-1"), ("P2", "B-2"), ("P2", "C-3")):
        np.testing.assert_allclose(_read(str(tmp_path / "port"), project, wsi),
                                   _read(str(tmp_path / "jax"), project, wsi),
                                   rtol=RTOL, atol=ATOL)
    assert seen == [("resnet", "cpu", ())]


def test_cli_kernel_set_and_flags(patch_root, extractors, tmp_path, monkeypatch, capsys):
    """On CUDA the ResNet extracts through K4 in every stage unless
    ``--kernels off``; UNI has no kernel; the data-parallel and fleet flags
    parse as JAX's; without CUDA the CLI raises."""
    seen = []
    _small_backbones(monkeypatch, extractors, seen)
    ref = tmp_path / "ref.csv"
    _ref([("A-1.svs", "P1")]).to_csv(ref, index=False)
    base = ["--ref_file", str(ref), "--patch_data_path", str(patch_root), "--weights", "random"]
    monkeypatch.setattr(tcli, "resolve_device", lambda d: torch.device(d or "cuda"))
    for i, extra in enumerate(([], ["--kernels", "off"], ["--feat_type", "uni"])):
        got = tcli.main([*base, *extra, "--feature_path", str(tmp_path / f"f{i}")])
        kernels = ["bottleneck_chain"] if i == 0 else []
        assert got["kernels"] == kernels
        assert f"compute_features: cuda, kernels: {kernels[0] if kernels else 'none'}" in \
            capsys.readouterr().err
    assert [s[2] for s in seen] == [(1, 2, 3, 4), (), ()]
    monkeypatch.undo()

    for flag, dest, value in ((["--data_parallel"], "data_parallel", True),
                              (["--multihost"], "multihost", True),
                              (["--coordinator", "h:1"], "coordinator", "h:1"),
                              (["--num_processes", "2"], "num_processes", 2),
                              (["--process_id", "1"], "process_id", 1)):
        args = tcli.build_parser().parse_args([*base, *flag])
        assert getattr(args, dest) == value == getattr(
            jcli.build_parser().parse_args([*base, *flag]), dest)
    jflags = {a.dest for a in jcli.build_parser()._actions}
    tflags = {a.dest for a in tcli.build_parser()._actions}
    assert jflags - tflags == set() and tflags - jflags == {"device", "kernels"}
    defaults = tcli.build_parser().parse_args(base)
    assert (defaults.max_patch_number, defaults.seed, defaults.batch_size,
            defaults.compute_dtype, defaults.device) == (4000, 99, 256, "float32", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([*base, "--feature_path", str(tmp_path / "none")])
