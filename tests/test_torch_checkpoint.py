"""The port's checkpoint readers and writers (``train/checkpoint.py``) and
``vis.replace_head`` against the JAX package's, on the same files."""

import builtins
import json
import sys
import types

import numpy as np
import pytest
import torch

import jax

from sequoia_tpu.models import convert as jconvert
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.train import checkpoint as jckpt
from sequoia_tpu_torch.models import convert, vis
from sequoia_tpu_torch.train import checkpoint
from tests.torch_goldens import make_torch_sd, vis_shapes

G, D, DEPTH, H, W, N = 6, 16, 2, 2, 4, 5


def _vis_sd(seed=0) -> dict[str, np.ndarray]:
    sd = make_torch_sd(torch.Generator().manual_seed(seed), vis_shapes(G, D, DEPTH, H, W, W, W, N))
    return {k: v.float().numpy() for k, v in sd.items()}


def _assert_same_sd(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_state_dict_pt_loads_as_in_jax(tmp_path):
    sd = _vis_sd()
    path = str(tmp_path / "model_best_0.pt")
    checkpoint.save_torch_state_dict(sd, path)
    got, want = checkpoint.load_torch_checkpoint(path), jckpt.load_torch_checkpoint(path)
    _assert_same_sd(got, want)
    _assert_same_sd(got, sd)
    # and the JAX writer's file reads the same through the port
    jpath = str(tmp_path / "jax.pt")
    jckpt.save_torch_state_dict(sd, jpath)
    _assert_same_sd(checkpoint.load_torch_checkpoint(jpath), sd)
    cfg, params = convert.vis_from_torch(got)
    assert (cfg.num_outputs, cfg.input_dim, cfg.depth, cfg.nheads) == (G, D, DEPTH, H)


def test_whole_module_pickle_shim_keeps_ks(tmp_path, monkeypatch):
    """A whole-module pickle whose class is not importable loads through the
    shim in both packages, with the module's ``ks`` sweep as ``__ks__``."""
    mod = types.ModuleType("he2rna_missing_module")

    class HE2RNA(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv0 = torch.nn.Conv1d(8, 6, 1)
            self.conv1 = torch.nn.Conv1d(6, 4, 1)
            self.ks = [1, 2, 5]

    HE2RNA.__module__ = "he2rna_missing_module"
    HE2RNA.__qualname__ = "HE2RNA"
    mod.HE2RNA = HE2RNA
    monkeypatch.setitem(sys.modules, "he2rna_missing_module", mod)
    torch.manual_seed(0)
    m = HE2RNA()
    path = str(tmp_path / "whole_module.pt")
    torch.save(m, path)
    want = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    monkeypatch.delitem(sys.modules, "he2rna_missing_module")

    got = checkpoint.load_torch_checkpoint(path)
    _assert_same_sd(got, jckpt.load_torch_checkpoint(path))
    np.testing.assert_array_equal(got.pop("__ks__"), [1, 2, 5])
    _assert_same_sd(got, want)


@pytest.mark.parametrize("layout", ["safetensors", "bin"])
def test_hf_dir_loads_as_in_jax(tmp_path, layout):
    sd = _vis_sd(1)
    if layout == "safetensors":
        from safetensors.numpy import save_file

        save_file(sd, str(tmp_path / "model.safetensors"))
    else:
        checkpoint.save_torch_state_dict(sd, str(tmp_path / "pytorch_model.bin"))
    (tmp_path / "config.json").write_text("{}")
    got = checkpoint.load_hf_vis_state_dict(str(tmp_path))
    _assert_same_sd(got, jckpt.load_hf_vis_state_dict(str(tmp_path)))
    _assert_same_sd(got, sd)


def test_save_hf_vis_layout_roundtrip(tmp_path):
    """The port's export reads back to the same parameters through the port
    and through the JAX package, with the reference constructor's config
    keys."""
    cfg = vis.ViSConfig(num_outputs=7, input_dim=32, depth=2, nheads=2, dim_f=4, dim_s=4,
                        dim_c=4, num_clusters=10)
    params = vis.init(cfg, torch.Generator().manual_seed(0))
    out = tmp_path / "hf"
    checkpoint.save_hf_vis_layout(str(out), cfg, params)
    conf = json.loads((out / "config.json").read_text())
    assert conf == {"num_outputs": 7, "input_dim": 32, "depth": 2, "nheads": 2,
                    "dimensions_f": 4, "dimensions_s": 4, "dimensions_c": 4,
                    "num_clusters": 10}
    assert (out / "model.safetensors").exists()
    cfg2, params2 = convert.vis_from_torch(checkpoint.load_hf_vis_state_dict(str(out)))
    assert cfg2 == cfg
    flat = lambda p: {k: v for k, v in p.items() if k != "blocks"} | p["blocks"]  # noqa: E731
    for k, v in flat(params).items():
        assert torch.equal(flat(params2)[k], v), k
    jcfg, jparams = jconvert.vis_from_torch(jckpt.load_hf_vis_state_dict(str(out)))
    assert (jcfg.num_outputs, jcfg.depth, jcfg.nheads) == (7, 2, 2)
    np.testing.assert_array_equal(np.asarray(jparams["head_w"]), params["head_w"].numpy())


def test_hf_dir_without_safetensors(tmp_path, monkeypatch):
    """Without the safetensors package the writer falls back to
    ``pytorch_model.bin`` (as JAX's does) and the reader of a
    ``model.safetensors`` says what it needs."""
    real_import = builtins.__import__

    def no_safetensors(name, *a, **kw):
        if name.split(".")[0] == "safetensors":
            raise ImportError("no safetensors")
        return real_import(name, *a, **kw)

    sd = _vis_sd(2)
    from safetensors.numpy import save_file

    save_file(sd, str(tmp_path / "model.safetensors"))
    monkeypatch.setattr(builtins, "__import__", no_safetensors)
    with pytest.raises(RuntimeError, match="safetensors"):
        checkpoint.load_hf_vis_state_dict(str(tmp_path))
    out = tmp_path / "bin"
    checkpoint._write_hf_dir(str(out), {"a": 1}, sd)
    assert (out / "pytorch_model.bin").exists() and not (out / "model.safetensors").exists()
    monkeypatch.setattr(builtins, "__import__", real_import)
    _assert_same_sd(checkpoint.load_hf_vis_state_dict(str(out)), sd)


def test_repo_id_raises():
    with pytest.raises(FileNotFoundError, match="local"):
        checkpoint.load_hf_vis_state_dict("gevaertlab/sequoia-brca-0")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replace_head_matches_jax(dtype):
    """Same shapes and dtypes as JAX's ``replace_head``, the body untouched,
    the head drawn with torch Linear bounds."""
    cfg = vis.ViSConfig(num_outputs=7, input_dim=32, depth=1, nheads=2, dim_f=4, dim_s=4,
                        dim_c=4, num_clusters=6)
    params = vis.init(cfg, torch.Generator().manual_seed(0), dtype=dtype)
    cfg2, new = vis.replace_head(cfg, params, 11, torch.Generator().manual_seed(1))
    jdt = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    jcfg = jvis.ViSConfig(num_outputs=7, input_dim=32, depth=1, nheads=2, dim_f=4, dim_s=4,
                          dim_c=4, num_clusters=6)
    jparams = jax.tree.map(lambda a: a.astype(jdt), jvis.init(jcfg, jax.random.PRNGKey(0)))
    jcfg2, jnew = jvis.replace_head(jcfg, jparams, 11, jax.random.PRNGKey(1))
    assert cfg2.num_outputs == jcfg2.num_outputs == 11
    for k in ("head_w", "head_b", "head_ln_scale", "head_ln_bias"):
        assert tuple(new[k].shape) == tuple(jnew[k].shape), k
        assert str(new[k].dtype).removeprefix("torch.") == str(jnew[k].dtype), k
    assert float(new["head_w"].abs().max()) <= 1 / np.sqrt(32)
    assert torch.equal(new["head_ln_scale"], torch.ones(32, dtype=dtype))
    assert new["blocks"] is params["blocks"] and new["pos_emb"] is params["pos_emb"]
    assert params["head_w"].shape == (32, 7)  # the input tree is not changed
