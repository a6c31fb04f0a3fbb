"""The port's host tools (``sequoia_tpu_torch/tools/make_example_data.py``,
``import_reference_artifacts.py``) against the JAX package's
``tools/make_example_data.py`` and ``tools/import_reference_artifacts.py`` on
the same arguments: the same files.  The port's tool runs in a subprocess in
which importing JAX, the JAX package or the repo's tests and tools raises."""

import io
import os
import pathlib
import pickle
import runpy
import subprocess
import sys
import zipfile

import h5py
import numpy as np
import pandas as pd
import pytest
from PIL import Image

from sequoia_tpu_torch.tools import import_reference_artifacts as tira
from tools import import_reference_artifacts as jira

ROOT = pathlib.Path(__file__).resolve().parents[1]
# run a module as __main__ with every import of JAX, the JAX package and the
# repo's tests and tools refused
BLOCKED_RUN = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sequoia_tpu", "tests", "tools"):
            raise ImportError("blocked import: " + name)
        return None
sys.meta_path.insert(0, Block())
module, sys.argv = sys.argv[1], sys.argv[1:]
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""
ARGS = ["--n_slides", "3", "--n_genes", "7", "--features", "--wsis", "--feature_dim", "16",
        "--n_tokens", "5"]


def run_blocked(module: str, argv: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", BLOCKED_RUN, module, *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def _levels(path) -> list[np.ndarray]:
    with Image.open(path) as im:
        out = []
        for i in range(im.n_frames):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")))
        return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX tool's and the port's outputs for the same arguments."""
    root = tmp_path_factory.mktemp("example")
    jax_out, port_out = root / "jax", root / "port"
    argv = sys.argv
    try:
        sys.argv = ["make_example_data.py", "--out", str(jax_out), *ARGS]
        runpy.run_path(str(ROOT / "tools" / "make_example_data.py"), run_name="__main__")
    finally:
        sys.argv = argv
    proc = run_blocked("sequoia_tpu_torch.tools.make_example_data",
                       ["--out", str(port_out), *ARGS])
    assert proc.returncode == 0, proc.stderr
    return jax_out, port_out, proc


def test_make_example_data_csvs_byte_equal(both):
    jax_out, port_out, proc = both
    for name in ("ref_file.csv", "gene_list.csv"):
        assert (port_out / name).read_bytes() == (jax_out / name).read_bytes(), name
    assert "wrote" in proc.stdout and "(3 slides, 7 genes)" in proc.stdout


def test_make_example_data_feature_store_equal(both):
    jax_out, port_out, _ = both
    files = sorted(p.relative_to(jax_out) for p in (jax_out / "features").rglob("*.h5"))
    assert len(files) == 3
    assert files == sorted(p.relative_to(port_out) for p in (port_out / "features").rglob("*.h5"))
    for rel in files:
        with h5py.File(jax_out / rel) as fj, h5py.File(port_out / rel) as ft:
            assert sorted(fj) == sorted(ft) == ["cluster_features", "resnet_features"]
            for key in fj:
                np.testing.assert_array_equal(ft[key][:], fj[key][:])
                assert ft[key].dtype == fj[key].dtype


def test_make_example_data_wsis_pixel_equal(both):
    jax_out, port_out, _ = both
    names = sorted(p.name for p in (jax_out / "HE").glob("*.tiff"))
    assert names == sorted(p.name for p in (port_out / "HE").glob("*.tiff"))
    assert len(names) == 3
    for name in names:
        want, got = _levels(jax_out / "HE" / name), _levels(port_out / "HE" / name)
        assert [a.shape for a in got] == [a.shape for a in want] == [(1536, 2048, 3),
                                                                    (384, 512, 3)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_synthetic_levels_match_the_jax_generator():
    from tests.test_pipeline_e2e import synthetic_wsi
    from sequoia_tpu_torch.tools.make_example_data import synthetic_levels

    for seed in (0, 3):
        want = synthetic_wsi(w=320, h=256, seed=seed).levels
        got = synthetic_levels(w=320, h=256, seed=seed)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_make_example_data_gene_list_option(tmp_path):
    """``--gene_list`` with ``--n_genes -1`` keeps every name, as the JAX tool."""
    from sequoia_tpu_torch.tools import make_example_data as tmed
    from tools import make_example_data as jmed

    pd.DataFrame({"gene_name": ["TP53", "EGFR", "MYC"]}).to_csv(tmp_path / "g.csv", index=False)
    for mod, out in ((jmed, tmp_path / "j"), (tmed, tmp_path / "t")):
        genes = mod.load_gene_list(str(tmp_path / "g.csv"), -1)
        mod.make_ref_file(str(out), 2, -1, "TCGA-SYNT", genes=genes)
    for name in ("ref_file.csv", "gene_list.csv"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


# ---------------------------------------------------------------------------
# import_reference_artifacts

def _reference_tree(root: pathlib.Path) -> pathlib.Path:
    """A small sequoia-pub layout: gene list, ref file, patient splits (a zip
    of pickled fold dicts with pandas indexes, and macOS junk), test WSIs,
    fold arrays."""
    ref = root / "sequoia-pub"
    (ref / "examples").mkdir(parents=True)
    (ref / "pre_processing").mkdir()
    (ref / "src" / "folds").mkdir(parents=True)
    genes = ["TP53", "EGFR", "MYC", "KRAS"]
    pd.DataFrame({"Unnamed: 0": range(4), "gene": genes}).to_csv(
        ref / "examples" / "gene_list.csv", index=False)
    rng = np.random.default_rng(0)
    pd.DataFrame({"wsi_file_name": [f"TCGA-{i}.svs" for i in range(5)],
                  "patient_id": [f"P{i // 2}" for i in range(5)],
                  **{f"rna_{g}": rng.normal(size=5) for g in genes[:3]},
                  "tcga_project": "TCGA-BRCA"}).to_csv(ref / "examples" / "ref_file.csv",
                                                       index=False)
    with zipfile.ZipFile(ref / "pre_processing" / "patient_splits.zip", "w") as z:
        for cancer in ("TCGA-BRCA", "TCGA-LUAD"):
            folds = {f"fold_{i}": {"train": pd.Index([f"P{i}", f"P{i + 5}"]),
                                   "val": pd.Index([f"V{i}"]), "test": pd.Index([f"T{i}"])}
                     for i in range(5)}
            buf = io.BytesIO()
            np.save(buf, np.asarray(folds, dtype=object), allow_pickle=True)
            z.writestr(f"patient_splits/{cancer}.npy", buf.getvalue())
            z.writestr(f"__MACOSX/patient_splits/._{cancer}.npy", b"junk")
    with open(ref / "pre_processing" / "test_wsis.pkl", "wb") as f:
        pickle.dump({"brca": {"split_0": ["TCGA-0", "TCGA-1"]},
                     "luad": {"split_0": ["TCGA-2"]}}, f)
    for c in ("brca", "luad"):
        for i in range(2):
            np.save(ref / "src" / "folds" / f"test-{c}-{i}.npy",
                    np.asarray([f"TCGA-{c}-{i}-{j}" for j in range(3)], dtype=object),
                    allow_pickle=True)
    (ref / "src" / "folds" / "README.txt").write_text("not an array")
    return ref


def test_import_reference_artifacts_same_outputs(tmp_path, capsys):
    ref = _reference_tree(tmp_path)
    want = jira.run(str(ref), str(tmp_path / "jax"))
    jax_report = capsys.readouterr().out
    got = tira.run(str(ref), str(tmp_path / "port"))
    assert got == want
    assert capsys.readouterr().out == jax_report
    assert got["patient_split_files"] == 2 and got["folds_per_cancer"] == [5]
    assert got["fold_arrays"] == 4 and got["gene_order_matches_ref_file"]
    jfiles = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                    if p.is_file())
    tfiles = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                    if p.is_file())
    assert tfiles == jfiles and len(jfiles) == 2 + 2 + 1 + 4
    for rel in jfiles:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def test_import_reference_artifacts_cli_runs_without_jax(tmp_path):
    ref = _reference_tree(tmp_path)
    proc = run_blocked("sequoia_tpu_torch.tools.import_reference_artifacts",
                       ["--reference", str(ref), "--out", str(tmp_path / "out")])
    assert proc.returncode == 0, proc.stderr
    assert "n_genes: 4" in proc.stdout and "fold_arrays: 4" in proc.stdout
    assert os.path.exists(tmp_path / "out" / "splits" / "patient_splits" / "TCGA-LUAD.npy")


def test_import_reference_artifacts_rejects_a_malformed_fold(tmp_path):
    ref = _reference_tree(tmp_path)
    with zipfile.ZipFile(ref / "pre_processing" / "patient_splits.zip", "w") as z:
        buf = io.BytesIO()
        np.save(buf, np.asarray({"fold_0": {"train": [1]}}, dtype=object), allow_pickle=True)
        z.writestr("TCGA-BAD.npy", buf.getvalue())
    for mod in (jira, tira):
        with pytest.raises(ValueError, match="fold 0 malformed"):
            mod.run(str(ref), str(tmp_path / mod.__name__))
