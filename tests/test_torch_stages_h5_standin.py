"""``chip_smoke.py``'s h5py stand-in (``MemoryH5``, for a machine where h5py
does not import) against h5py: the port's three stage CLIs (tiling in both
layouts, features under a binding cap, k-means) run once on real HDF5 files
and once with the stand-in in ``sys.modules["h5py"]``, and every dataset,
its dtype, the key order and every other file come out byte-equal.  That
pins h5py's name order and the ``random.sample`` stream that depends on it.
The stand-in also raises where h5py does, and leaves ``sys.modules`` as it
found it."""

import os
import sys

import h5py
import numpy as np
import pytest
import torch

import chip_smoke
from sequoia_tpu_torch.cli import compute_features as tcf
from sequoia_tpu_torch.cli import kmean_features as tkm
from sequoia_tpu_torch.cli import patch_gen as tpg
from sequoia_tpu_torch.models import resnet as tresnet
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from tests.test_pipeline_e2e import synthetic_wsi

PS, K = 64, 4


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from sequoia_tpu_torch import native

    root = tmp_path_factory.mktemp("standin_inputs")
    os.makedirs(root / "wsi")
    for i in range(2):
        slide = synthetic_wsi(w=768, h=576, seed=i)
        native.write_tiled_tiff(str(root / "wsi" / f"S-{i}.tiff"), slide.levels,
                                tile=(128, 128))
    (root / "ref.csv").write_text("wsi_file_name,patient_id,tcga_project\n"
                                  "S-0.svs,P0,TCGA-X\nS-1.svs,P1,TCGA-X\n")
    return root


def _run_stages(inputs, out, monkeypatch):
    """Tile (both layouts), extract with a cap of 9 from each layout, cluster."""
    tres = tresnet.random_params(torch.Generator().manual_seed(0))
    tres.update({f"layer{s}": tres[f"layer{s}"][:1] for s in range(1, 5)})
    monkeypatch.setattr(tcf, "load_extractor", lambda *a, **kw: FeatureExtractor(
        "resnet", tres, batch_size=8, patch_size=PS, device="cpu",
        cfg=tresnet.ResNetConfig(blocks_per_stage=(1, 1, 1, 1))))
    os.makedirs(out)
    ref = str(inputs / "ref.csv")
    for layout in ("tiles", "packed"):
        tpg.main(["--wsi_path", str(inputs / "wsi"), "--patch_path", f"{out}/{layout}",
                  "--mask_path", f"{out}/{layout}_masks", "--patch_size", "64", "--layout",
                  layout, "--device", "cpu"])
        assert tcf.main(["--ref_file", ref, "--patch_data_path", f"{out}/{layout}",
                         "--feature_path", f"{out}/feat_{layout}", "--weights", "random",
                         "--max_patch_number", "9", "--device", "cpu"])["slides"] == 2
        assert tkm.main(["--ref_file", ref, "--feature_path", f"{out}/feat_{layout}",
                         "--num_clusters", str(K), "--backend", "hybrid",
                         "--device", "cpu"])["slides"] == 2


def _h5_contents(path, mem):
    """{name: (dtype, shape, bytes)} in key order, from h5py or the stand-in."""
    if mem is None:
        with h5py.File(path, "r") as f:
            return [(k, f[k].dtype.str, f[k].shape, f[k][:].tobytes()) for k in f.keys()]
    f = mem.File(path, "r")
    return [(k, f[k].dtype.str, f[k].shape, f[k][:].tobytes()) for k in f.keys()]


def _tree(root, mem):
    out = {}
    for d, _, files in os.walk(root):
        for n in files:
            path = os.path.join(d, n)
            rel = os.path.relpath(path, root)
            out[rel] = (_h5_contents(path, mem) if n.endswith((".h5", ".hdf5"))
                        else open(path, "rb").read())
    return out


def test_stages_on_the_standin_equal_h5py(inputs, tmp_path, monkeypatch):
    _run_stages(inputs, str(tmp_path / "files"), monkeypatch)
    real = sys.modules["h5py"]
    with chip_smoke.memory_h5() as mem:
        import h5py as inside

        assert inside is mem
        _run_stages(inputs, str(tmp_path / "memory"), monkeypatch)
    assert sys.modules["h5py"] is real
    want, got = _tree(str(tmp_path / "files"), None), _tree(str(tmp_path / "memory"), mem)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    # the tiles layout's names, in h5py's byte-wise order
    tiles = [k for k, *_ in want[os.path.join("tiles", "S-0", "S-0.hdf5")]]
    assert tiles == sorted(tiles, key=str.encode) and len(tiles) > 9
    feats = [v for k, v in want.items() if k.startswith("feat_") and k.endswith(".h5")]
    assert len(feats) == 4 and all([k for k, *_ in v] == ["cluster_features",
                                                          "resnet_features"] for v in feats)


def test_standin_raises_where_h5py_does(tmp_path):
    with chip_smoke.memory_h5() as mem:
        with pytest.raises(OSError):
            mem.File(str(tmp_path / "missing.h5"), "r")
        with pytest.raises(OSError):
            mem.File(str(tmp_path / "missing.h5"), "r+")
        with pytest.raises(OSError):
            mem.File(str(tmp_path / "no_dir" / "x.h5"), "w")
        path = str(tmp_path / "a.h5")
        with mem.File(path, "w") as f:
            d = f.create_dataset("x", shape=(0, 2), maxshape=(4, 2), dtype=np.int64)
            d.resize(3, axis=0)
            d[1:] = [[1, 2], [3, 4]]
            with pytest.raises(ValueError):
                d.resize(5, axis=0)
            with pytest.raises(ValueError):
                f.create_dataset("x", data=np.zeros(2))
        assert os.path.exists(path)  # path checks hold, as for a real file
        with mem.File(path, "r") as f:
            assert f["x"].shape == (3, 2) and f["x"].dtype == np.int64
            np.testing.assert_array_equal(f["x"][np.array([0, 2])], [[0, 0], [3, 4]])
            with pytest.raises(TypeError, match="increasing"):
                f["x"][np.array([2, 0])]
            with pytest.raises(ValueError):
                f.create_dataset("y", data=np.zeros(2))
            with pytest.raises(KeyError):
                f["y"]
        mem.copy_tree(str(tmp_path), str(tmp_path / "copy"))
        assert mem.File(str(tmp_path / "copy" / "a.h5"), "r")["x"].shape == (3, 2)
    assert "h5py" in sys.modules and sys.modules["h5py"] is h5py
