"""The tiling stage of the port against the JAX package on the CPU:
``pipeline/patch_gen.extract_patches`` writes the same HDF5 (every dataset
bit for bit, with its dtype, chunks and maxshape), mask and sentinel in both
layouts, with and without a binding cap and at AppMag 40 (the Pillow resize);
decodes as many regions before the cap stops it; skips a finished slide;
quarantines a failing one in ``run_patch_gen``; and ``cli.patch_gen`` gives
the JAX CLI's outputs for the same argv."""

import os

import h5py
import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)

from sequoia_tpu.cli import patch_gen as jcli
from sequoia_tpu.pipeline import patch_gen as jpg
from sequoia_tpu_torch.cli import patch_gen as tcli
from sequoia_tpu_torch.data.wsi import ArrayReader
from sequoia_tpu_torch.pipeline import patch_gen as tpg
from tests.test_pipeline_e2e import synthetic_wsi

PS = (64, 64)


def _slide(seed=0):
    """One slide size for the whole file, so that JAX compiles the slide
    mask once."""
    return synthetic_wsi(w=768, h=576, seed=seed)


def _appmag40():
    """The slide at AppMag 40: 128-px regions resized to 64 (JAX
    tests/test_pipeline_e2e.py:178)."""
    return ArrayReader(_slide(3).levels, properties={"aperio.AppMag": "40"})


def _datasets(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k][:], f[k].dtype, f[k].chunks, f[k].maxshape) for k in f.keys()}


def assert_same_output(a, b, slide_id):
    """Two patch roots hold the same slide output: HDF5 datasets (in h5py's
    order), the sentinel's text and (under ``{root}_masks``) the mask."""
    da = _datasets(os.path.join(a, slide_id, f"{slide_id}.hdf5"))
    db = _datasets(os.path.join(b, slide_id, f"{slide_id}.hdf5"))
    assert list(da) == list(db)
    for k in da:
        np.testing.assert_array_equal(db[k][0], da[k][0])
        assert db[k][1:] == da[k][1:], k
    sentinels = [os.path.join(r, slide_id, "complete.txt") for r in (a, b)]
    if os.path.exists(sentinels[0]):
        assert open(sentinels[1]).read() == open(sentinels[0]).read()
    else:
        assert not os.path.exists(sentinels[1])
    np.testing.assert_array_equal(np.load(os.path.join(b + "_masks", slide_id, "mask.npy")),
                                  np.load(os.path.join(a + "_masks", slide_id, "mask.npy")))


def _both(tmp_path, slide, layout, cap, name="S", **more):
    kw = dict(max_patches_per_slide=cap, verbose=False, layout=layout, **more)
    j, t = str(tmp_path / f"jax_{layout}_{cap}"), str(tmp_path / f"port_{layout}_{cap}")
    nj = jpg.extract_patches(slide(), j, j + "_masks", name, PS, **kw)
    nt = tpg.extract_patches(slide(), t, t + "_masks", name, PS, device="cpu", **kw)
    return nj, nt, j, t


@pytest.mark.parametrize("layout", ["tiles", "packed"])
@pytest.mark.parametrize("cap", [None, 25])
def test_extract_patches_matches_jax(tmp_path, layout, cap):
    nj, nt, j, t = _both(tmp_path, _slide, layout, cap)
    assert nt == nj == (cap or nj) >= 25
    assert_same_output(j, t, "S")


@pytest.mark.parametrize("layout", ["tiles", "packed"])
def test_extract_patches_appmag40_matches_jax(tmp_path, layout):
    nj, nt, j, t = _both(tmp_path, _appmag40, layout, 6)
    assert nt == nj == 6
    assert_same_output(j, t, "S")
    with h5py.File(os.path.join(t, "S", "S.hdf5"), "r") as f:
        if layout == "tiles":
            coords = np.array([list(map(int, k.split("_"))) for k in f.keys()])
            assert all(f[k].shape == (64, 64, 3) for k in f.keys())
        else:
            coords = f["coords"][:]
            assert f["patches"].shape == (6, 64, 64, 3)
    assert (coords % 128 == 0).all()  # the grid steps by the 128-px region


def test_cap_stops_decoding_like_jax(tmp_path, monkeypatch):
    """With a cap the first screen batch fills, both stop after decoding that
    batch: the rest of the candidates is never read."""
    decoded = {"jax": 0, "port": 0}

    def counting(mod, key):
        real = mod.read_regions

        def read(slide, locs, level, size, *a, **kw):
            decoded[key] += len(locs)
            return real(slide, locs, level, size, *a, **kw)
        return read

    import sequoia_tpu.data.wsi as jwsi

    monkeypatch.setattr(jwsi, "read_regions", counting(jwsi, "jax"))
    monkeypatch.setattr(tpg, "read_regions", counting(tpg, "port"))
    slide = _slide()
    n_cand = len(tpg.masked_candidates(slide, *tpg.compute_slide_mask(slide, device="cpu"),
                                       64)[0])
    nj, nt, _, _ = _both(tmp_path, _slide, "tiles", 5, screen_batch=16)
    assert nj == nt == 5
    assert decoded["port"] == decoded["jax"] == 16 < n_cand


def test_finished_slide_skipped_and_quarantine(tmp_path, capsys):
    root = str(tmp_path / "p")
    assert tpg.extract_patches(_slide(), root, root + "_masks", "S", PS,
                               verbose=False, device="cpu") > 0
    assert tpg.extract_patches(_slide(), root, root + "_masks", "S", PS,
                               device="cpu") == -1
    assert "S: patches have already been extracted" in capsys.readouterr().out
    with pytest.raises(ValueError, match="layout"):
        tpg.extract_patches(_slide(), root, root + "_masks", "T", PS,
                            layout="zarr", device="cpu")

    slides = {"missing": str(tmp_path / "missing.tiff"), "S2": _slide()}
    got = tpg.run_patch_gen(slides, root, root + "_masks", patch_size=64, verbose=False,
                            device="cpu")
    port_out = capsys.readouterr().out
    jpg.run_patch_gen(slides, str(tmp_path / "j"), str(tmp_path / "jm"), patch_size=64,
                      verbose=False)
    jax_out = capsys.readouterr().out
    assert list(got) == ["S2"] and got["S2"] > 0
    assert port_out.startswith("error with slide id missing: ")
    assert jax_out.startswith("error with slide id missing: ")


@pytest.fixture(scope="module")
def wsi_dir(tmp_path_factory):
    """Two slides and a same-stem duplicate as tiled TIFFs, and a file that is
    not a slide."""
    from sequoia_tpu_torch import native

    root = tmp_path_factory.mktemp("wsi")
    for name, seed in (("A-1.svs", 0), ("B-2.tiff", 1), ("A-1.extra.tiff", 2)):
        slide = _slide(seed)
        native.write_tiled_tiff(str(root / name), slide.levels, tile=(128, 128))
    (root / "notes.txt").write_text("not a slide")
    (tmp_path_factory.getbasetemp() / "ref.csv").write_text(
        "wsi_file_name,patient_id\nB-2,P2\nA-1.svs,P1\n")
    return root


@pytest.mark.parametrize("extra", [[], ["--layout", "packed", "--end", "1"],
                                   ["--ref_file", "REF"], ["--debug", "1"]])
def test_cli_matches_jax(wsi_dir, tmp_path, extra, capsys):
    extra = [str(wsi_dir.parent / "ref.csv") if a == "REF" else a for a in extra]
    outs = {}
    for name, cli, more in (("jax", jcli, []), ("port", tcli, ["--device", "cpu"])):
        root = str(tmp_path / name)
        cli.main(["--wsi_path", str(wsi_dir), "--patch_path", root, "--mask_path",
                  root + "_masks", "--patch_size", "64", *extra, *more])
        outs[name] = (root, capsys.readouterr().out)
    (j, jout), (t, tout) = outs["jax"], outs["port"]
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))
    for sid in os.listdir(j):
        assert_same_output(j, t, sid)
    for line in ("Found", "warning"):
        assert [ln for ln in tout.splitlines() if ln.startswith(line)] == \
            [ln for ln in jout.splitlines() if ln.startswith(line)]
    if "--debug" in extra:
        with h5py.File(os.path.join(t, "A-1", "A-1.hdf5"), "r") as f:
            assert len(f.keys()) == 20


def test_cli_flags(wsi_dir, tmp_path, monkeypatch, capsys):
    for flag, dest, value in ((["--multihost"], "multihost", True),
                              (["--coordinator", "h:1"], "coordinator", "h:1"),
                              (["--num_processes", "2"], "num_processes", 2),
                              (["--process_id", "0"], "process_id", 0)):
        assert getattr(tcli.build_parser().parse_args(["--wsi_path", "x", *flag]),
                       dest) == value
    jflags = {a.dest for a in jcli.build_parser()._actions}
    tflags = {a.dest for a in tcli.build_parser()._actions}
    assert tflags - jflags == {"device"} and jflags <= tflags
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--wsi_path", str(wsi_dir), "--patch_path", str(tmp_path / "p")])
    assert not (tmp_path / "p").exists()
