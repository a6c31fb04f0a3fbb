"""Sharded train states through ``torch.distributed.checkpoint`` (the port's
counterpart of ``save_orbax``/``load_orbax``, ``train/checkpoint.py``): a
tree saved from a (1, 2) world of gloo ranks (each writing its own shard)
loads whole in one process, and a whole tree saved in one process loads
into each rank's (1, 2) pieces; both bit-equal, bf16 leaves too.  Also the
single-process round trip with ``like`` and without it."""

import numpy as np
import torch

from sequoia_tpu_torch.parallel import multihost as mh
from sequoia_tpu_torch.train import checkpoint
from tests import torch_mh_workers as workers


def _tree():
    rng = np.random.default_rng(3)
    return {"pos_emb": rng.normal(size=(5, 8)).astype(np.float32),
            "head_w": rng.normal(size=(8, 6)).astype(np.float32),
            "head_b": rng.normal(size=(6,)).astype(np.float32)}


def test_save_on_two_ranks_load_in_one_process_and_back(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ranks")
    shapes = mh.spawn_local(workers.dcp_save, 2, (path, tree, 2), timeout=120)
    assert [tuple(s) for s in shapes] == [(8, 3), (8, 3)]
    assert sorted(p.name for p in (tmp_path / "ranks").iterdir()) == [
        ".metadata", "__0_0.distcp", "__1_0.distcp"]
    got = checkpoint.load_sharded(path, like={k: torch.zeros(v.shape) for k, v in tree.items()})
    for k, v in tree.items():
        assert torch.equal(got[k], torch.from_numpy(v)), k
    flat = checkpoint.load_sharded(path)
    assert sorted(flat) == sorted(tree) and torch.equal(flat["head_w"],
                                                        torch.from_numpy(tree["head_w"]))

    one = str(tmp_path / "one")
    checkpoint.save_sharded(one, {k: torch.from_numpy(v) for k, v in tree.items()})
    for whole in mh.spawn_local(workers.dcp_load, 2, (one, tree, 2), timeout=120):
        for k, v in tree.items():
            np.testing.assert_array_equal(whole[k], v)


def test_single_process_round_trip_keeps_dtypes(tmp_path):
    tree = {"params": {"head_w": torch.randn(4, 6), "blocks": {"w": torch.randn(2, 3)}},
            "mu": {"head_w": torch.randn(4, 6).bfloat16(), "blocks": {"w": torch.zeros(2, 3)}}}
    checkpoint.save_sharded(str(tmp_path / "s"), tree)
    like = {"params": {"head_w": torch.zeros(4, 6), "blocks": {"w": torch.zeros(2, 3)}},
            "mu": {"head_w": torch.zeros(4, 6, dtype=torch.bfloat16),
                   "blocks": {"w": torch.ones(2, 3)}}}
    got = checkpoint.load_sharded(str(tmp_path / "s"), like=like)
    for a, b in ((got["params"]["head_w"], tree["params"]["head_w"]),
                 (got["mu"]["head_w"], tree["mu"]["head_w"]),
                 (got["mu"]["blocks"]["w"], tree["mu"]["blocks"]["w"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
