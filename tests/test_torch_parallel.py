"""The port's ``parallel`` package against the JAX package's on the CPU:
``process_shard``'s row ranges, the partition specs of a ViS tree and of its
AdamW moments (LowMemAdamW's too), the in-process mesh's layout and
placement, and ``fleet_shard_rows`` without ``--multihost``.  The
multi-process paths run in tests/test_torch_multihost.py."""

import argparse

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from sequoia_tpu.models import vis as jvis
from sequoia_tpu.parallel import multihost as jmh
from sequoia_tpu.parallel import sharding as jsh
from sequoia_tpu.train import loop as jloop
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.parallel import multihost as mh
from sequoia_tpu_torch.parallel import sharding as sh
from sequoia_tpu_torch.train import loop

CFG = dict(num_outputs=8, input_dim=16, depth=2, nheads=2, dim_f=4, dim_s=4, dim_c=4,
           num_clusters=5)


@pytest.mark.parametrize("n", [0, 1, 2, 5, 10, 11, 64])
@pytest.mark.parametrize("procs", [1, 2, 3, 4, 7])
def test_process_shard_matches_jax(n, procs):
    got = [mh.process_shard(n, p, procs) for p in range(procs)]
    assert got == [jmh.process_shard(n, p, procs) for p in range(procs)]
    assert [i for s, e in got for i in range(s, e)] == list(range(n))
    assert mh.process_shard(2, 3, 4) == jmh.process_shard(2, 3, 4) == (2, 2)


def _trees():
    jc = jvis.ViSConfig(**CFG)
    jp = jvis.init(jc, jax.random.PRNGKey(0))
    return jp, convert.vis_params_from_numpy(jax.tree.map(np.asarray, jp))


def _port_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _port_paths(v, prefix + (k,))]
    return [prefix]


def _jax_specs(tree):
    return {tuple(k.key for k in path): tuple(s) for path, s in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))}


def test_param_specs_mirror_jax():
    jp, tp = _trees()
    want = _jax_specs(jsh.param_pspecs(jp))
    got = dict(zip(_port_paths(tp), sh.leaf_specs(tp)))
    assert got == want
    assert got[("head_w",)] == (None, "model") and got[("head_b",)] == ("model",)
    assert sh.param_pspecs({"w": torch.zeros(2)}) == {"w": ()}


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_moment_specs_mirror_jax(moment_dtype):
    jp, tp = _trees()
    jopt = jloop.make_adamw(1e-3, moment_dtype=moment_dtype)
    jstate = jsh.opt_state_pspecs(jopt.init(jp), jp)
    mu = jstate[0].mu if moment_dtype is None else jstate["mu"]
    want = _jax_specs(mu)
    params = loop.tree_map(lambda t: t.requires_grad_(True), tp)
    opt = loop.make_adamw(params, moment_dtype=moment_dtype)
    for leaf in loop.tree_leaves(params):
        leaf.grad = torch.ones_like(leaf)
    opt.step()
    specs = sh.opt_state_pspecs(opt.state_dict(), params)["state"]
    paths = _port_paths(tp)
    for i, st in specs.items():
        assert st["exp_avg"] == st["exp_avg_sq"] == want[paths[i]]
        assert st["step"] == ()


def test_in_process_mesh_layout_and_placement():
    mesh = sh.make_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.shape == jsh.make_mesh(2, 2, devices=jax.devices()[:4]).shape
    assert [(i, j) for i, j, _ in mesh.cells()] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    with pytest.raises(ValueError, match="needs 6 devices"):
        sh.make_mesh(3, 2, devices=["cpu"] * 4)
    assert sh.make_mesh(n_model=2, devices=["cpu"] * 6).shape == {"data": 3, "model": 2}
    _, tp = _trees()
    grid = sh.shard_params(mesh, tp)
    for i in range(2):
        for j in range(2):
            assert torch.equal(grid[i][j]["head_w"], tp["head_w"][:, 4 * j:4 * j + 4])
            assert torch.equal(grid[i][j]["head_b"], tp["head_b"][4 * j:4 * j + 4])
            assert torch.equal(grid[i][j]["pos_emb"], tp["pos_emb"])
    f, r, v = torch.randn(4, 5, 16), torch.randn(4, 8), torch.ones(4, dtype=torch.bool)
    cells = sh.shard_batch_arrays(mesh, f, r, v)
    assert torch.equal(cells[1][0][0], f[2:]) and torch.equal(cells[1][1][1], r[2:, 4:])
    assert [t.shape[0] for t in sh.dp_images(mesh, torch.zeros(6, 3))] == [3, 3]
    with pytest.raises(ValueError, match="not divisible"):
        sh.shard_batch_arrays(mesh, f[:3], r[:3], v[:3])
    with pytest.raises(ValueError, match="not divisible"):
        sh.shard_axis(torch.zeros(2, 7), 1, 2, 0)
    assert sh.local_devices("cpu") == [torch.device("cpu")]


def test_global_mesh_pieces_of_one_rank():
    """A rank's piece and the whole tree back (a world of one: the
    collectives are identities)."""
    mesh = mh.GlobalMesh(np.arange(4).reshape(2, 2), 3, torch.device("cpu"), None, None)
    assert (mesh.data_index, mesh.model_index, mesh.shape) == (1, 1, {"data": 2, "model": 2})
    _, tp = _trees()
    mine = sh.shard_params(mesh, tp)
    assert torch.equal(mine["head_w"], tp["head_w"][:, 4:])
    f, r, v = sh.shard_batch_arrays(mesh, torch.randn(4, 5, 16), torch.arange(32.).view(4, 8),
                                    torch.ones(4, dtype=torch.bool))
    assert f.shape == (2, 5, 16) and torch.equal(r, torch.arange(32.).view(4, 8)[2:, 4:])
    # the train loop's upload cuts a host batch to the same piece
    from sequoia_tpu_torch.data.dataset import Batch
    from sequoia_tpu_torch.train import loop

    feats = np.arange(4 * 5 * 16, dtype=np.float32).reshape(4, 5, 16)
    rna = np.arange(32, dtype=np.float32).reshape(4, 8)
    up = loop._uploader(torch.device("cpu"), None, mesh)(
        Batch(feats, rna, np.ones(4, bool), [""] * 4, [""] * 4))
    assert torch.equal(up[0], torch.from_numpy(feats[2:]))
    assert torch.equal(up[1], torch.from_numpy(rna[2:, 4:])) and up[2].shape == (2,)
    with pytest.raises(ValueError, match="not divisible"):
        loop._uploader(torch.device("cpu"), None, mesh)(
            Batch(feats[:3], rna[:3], np.ones(3, bool), [""] * 3, [""] * 3))


def test_fleet_shard_rows_without_flag_and_fleet_args():
    df = pd.DataFrame({"a": range(5)})
    assert mh.fleet_shard_rows(df, argparse.Namespace(multihost=False)) is df
    assert jmh.fleet_shard_rows(df, argparse.Namespace(multihost=False)) is df
    p, jp = argparse.ArgumentParser(), argparse.ArgumentParser()
    mh.add_fleet_args(p)
    jmh.add_fleet_args(jp)
    argv = ["--multihost", "--coordinator", "h:1", "--num_processes", "2", "--process_id", "1"]
    assert vars(p.parse_args(argv)) == vars(jp.parse_args(argv))
    assert vars(p.parse_args([])) == vars(jp.parse_args([]))


def test_initialize_refuses_partial_triplet(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="need --coordinator"):
        mh.initialize(None, 2, 0)
    with pytest.raises(ValueError, match="need --coordinator"):
        jmh.initialize(None, 2, 0)
    with pytest.raises(ValueError, match="--num_processes and --process_id"):
        mh.initialize("h:1", 2, None)
    with pytest.raises(ValueError, match="torchrun"):
        mh.initialize()
    assert mh.process_index() == 0 and mh.process_count() == 1
    assert mh.mesh_from_args(argparse.Namespace(multihost=False)) is None
