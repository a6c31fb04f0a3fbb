"""The port's sharded ViS train step over 2 and 4 gloo ranks on the CPU
(``parallel.multihost.spawn_local``), on tests/multihost_case.py's fixture:
meshes (data, model) = (2, 1), (1, 2) and (2, 2), three AdamW steps in f32
and with ``LowMemAdamW``'s bf16 moments.  Every rank reads the same metrics;
they match the port's single-process step and JAX's at
tests/test_multihost.py:95-98's tolerances (loss rtol 1e-5, corr rtol 1e-4),
the parameters and moments after three steps match the single process's,
each rank holds 1/n_model of the head and of its moments, and a model group
never spans "hosts" (ranks per host from ``LOCAL_WORLD_SIZE``)."""

import numpy as np
import pytest

import jax

from sequoia_tpu.models import vis as jvis
from sequoia_tpu.train import loop as jloop
from sequoia_tpu_torch.parallel import multihost as mh
from tests import torch_mh_workers as workers
from tests.multihost_case import CASE, local_shard

CFG = CASE["vis"]
FULL_HEAD = 4 * CFG["input_dim"] * CFG["num_outputs"]


def _batches():
    """Three global batches of 8 rows (two processes' shards of the fixture)."""
    return [tuple(np.concatenate([local_shard(2 * k + p, 2)[i] for p in range(2)])
                  for i in range(3)) for k in range(3)]


@pytest.fixture(scope="module")
def case():
    jp = jvis.init(jvis.ViSConfig(**CFG), jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, jp)
    batches = _batches()
    # JAX's single-process step (tests/test_multihost.py's oracle), three steps
    cfg = jvis.ViSConfig(**CFG)
    optimizer = jloop.make_adamw(1e-3)
    step, _ = jloop.make_step_fns(lambda p, x: jvis.apply(cfg, p, x), optimizer)
    state, params, jmetrics = optimizer.init(jp), jp, []
    for b in batches:
        params, state, m = step(params, state, *b)
        jmetrics.append({k: float(v) for k, v in m.items()})
    single = {md: workers.single_steps(CFG, params_np, batches, md)
              for md in (None, "bfloat16")}
    worlds = {2: mh.spawn_local(workers.mesh_runs, 2, (CFG, params_np, batches, [
                  (1, None, None), (2, None, None), (1, "bfloat16", None),
                  (2, "bfloat16", None)]), timeout=300),
              4: mh.spawn_local(workers.mesh_runs, 4, (CFG, params_np, batches, [
                  (2, None, 2), (2, "bfloat16", 2)], (4, 2)), timeout=300)}
    refusal = [r[-1] for r in worlds[4]]
    return jmetrics, single, worlds, refusal


RUNS = [(2, 0, 1, None), (2, 1, 2, None), (2, 2, 1, "bfloat16"), (2, 3, 2, "bfloat16"),
        (4, 0, 2, None), (4, 1, 2, "bfloat16")]


@pytest.mark.parametrize("world,run,n_model,moment_dtype", RUNS,
                         ids=[f"{w}ranks-model{m}-{d or 'f32'}" for w, _, m, d in RUNS])
def test_sharded_step_matches_single_process(case, world, run, n_model, moment_dtype):
    jmetrics, single, worlds, _ = case
    ranks = [r[run] for r in worlds[world]]
    one = single[moment_dtype]
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]  # every rank reads the same values
        for got, want, jwant in zip(r["metrics"], one["metrics"], jmetrics):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["corr"], want["corr"], rtol=1e-4)
            np.testing.assert_allclose(got["mae"], want["mae"], rtol=1e-5)
            if moment_dtype is None:  # JAX's f32 optax step
                np.testing.assert_allclose(got["loss"], jwant["loss"], rtol=1e-5)
                np.testing.assert_allclose(got["corr"], jwant["corr"], rtol=1e-4)
        for k in ("loss", "mae", "corr", "smape"):
            np.testing.assert_allclose(r["eval"][k], one["eval"][k], rtol=1e-4)
    r0 = ranks[0]
    for path in ("head_w", "head_b", "pos_emb"):
        a, b = r0["params"][path], one["params"][path]
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), path
    # f32 moments to f32 rounding; bf16 moments within two bf16 ulps of the max
    tol = 1e-4 if moment_dtype is None else 2 ** -7
    for i, m in r0["moments"].items():
        b = one["moments"][i]
        assert np.abs(m - b).max() <= tol * max(np.abs(b).max(), 1e-12), i
    # head TP shards the head and its moments: 1/n_model of their bytes a rank
    moment_full = FULL_HEAD // (2 if moment_dtype == "bfloat16" else 1)
    for r in ranks:
        assert r["head_bytes"] * n_model == FULL_HEAD
        assert r["moment_bytes"] * n_model == moment_full
        assert r["moment_dtype"] == ("torch.bfloat16" if moment_dtype else "torch.float32")


def test_model_groups_stay_inside_a_host(case):
    *_, worlds, refusal = case
    # 4 ranks as 2 hosts of 2: each (2, 2) model group is one host's ranks
    for rank, r in enumerate(worlds[4]):
        group = r[0]["model_group"]
        assert group == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert len({g // 2 for g in group}) == 1
    # a model axis wider than a host's ranks is refused on every rank
    assert all(msg and "must divide local device count 2" in msg for msg in refusal)
