"""``loop.train(mesh=)``'s resume state on the CPU: saved whole by one
process after an epoch, it resumes on a (1, 2) mesh of gloo ranks (each
rank cutting its head slice and moments from the file) to the unsharded
resume's metrics and parameters within rtol 1e-5."""

import shutil

import numpy as np
import torch

from sequoia_tpu_torch.models import vis
from sequoia_tpu_torch.parallel import multihost as mh
from tests import torch_mh_workers as workers
from tests.test_data_and_train import make_store

GENES, DIM = 4, 16


def test_resume_state_reshards(tmp_path):
    df = make_store(str(tmp_path / "f"), n_slides=12, n_genes=GENES, dim=DIM, tokens=5)
    root = tmp_path
    cfg = dict(num_outputs=GENES, input_dim=DIM, depth=1, nheads=2, dim_f=4, dim_s=4,
               dim_c=4, num_clusters=5)
    params = vis.init(vis.ViSConfig(**cfg), torch.Generator().manual_seed(0))
    params_np = {k: (v.numpy() if torch.is_tensor(v) else {kk: vv.numpy()
                                                           for kk, vv in v.items()})
                 for k, v in params.items()}
    feat = str(root / "f")
    # one process trains 1 epoch, saving its state whole
    state = str(tmp_path / "state.npz")
    # a world of one in this process: no process group, the sums are identities
    workers.train_resumed(df, feat, cfg, params_np, 1, state, 1)
    again = str(tmp_path / "again.npz")
    shutil.copy(state, again)
    # one process and the (1, 2) mesh each resume it for epochs 1 and 2
    # (a resumed loader starts its shuffle again at epoch 0, in JAX too, so
    # both resume: the sharded run is held to the unsharded resume)
    want = workers.train_resumed(df, feat, cfg, params_np, 1, again, 3)
    got = mh.spawn_local(workers.train_resumed, 2, (df, feat, cfg, params_np, 2, state, 3),
                         timeout=120)[0]
    assert got[0][0] == want[0][0]  # epoch 0 comes from the file
    assert len(got[0]) == len(want[0]) == 3
    for a, b in zip(got[0][1:], want[0][1:]):
        for phase in b:
            for k in b[phase]:
                np.testing.assert_allclose(a[phase][k], b[phase][k], rtol=1e-5)
    for k in ("head_w", "head_b", "pos_emb"):
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-5, atol=1e-7)
