"""Port ops/stats.py against the JAX package on the CPU: every statistic on a
full batch, a partial ``valid`` mask over rows of garbage, constant-target
genes, and an all-skipped batch whose mean correlation is NaN."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequoia_tpu.ops import stats as jstats
from sequoia_tpu_torch.ops import stats as tstats

FUNCS = ("masked_mse", "masked_mae", "masked_smape", "pearson_per_gene", "mean_correlation")


def _case(name):
    rng = np.random.default_rng(len(name))
    pred = rng.normal(size=(8, 12)).astype(np.float32)
    real = rng.normal(size=(8, 12)).astype(np.float32)
    valid = np.ones(8, bool)
    if name == "partial":
        valid[[2, 5, 6]] = False
        pred[~valid] = 1e3 * rng.normal(size=(3, 12))  # padding must not count
    elif name == "constant_genes":
        real[:, [1, 7]] = 0.5
        real[:, 4] = 0.0
        pred[3, 4] = real[3, 4] = 0.0  # a 0/0 SMAPE element
    elif name == "all_skipped":
        real[:] = 1.25
    elif name == "one_row":
        valid[1:] = False
    return pred, real, valid


@pytest.mark.parametrize("case", ["full", "partial", "constant_genes", "all_skipped", "one_row"])
@pytest.mark.parametrize("fn", FUNCS)
def test_statistic_matches_jax(fn, case):
    pred, real, valid = _case(case)
    want = np.asarray(getattr(jstats, fn)(jnp.asarray(pred), jnp.asarray(real),
                                          jnp.asarray(valid)))
    got = getattr(tstats, fn)(torch.as_tensor(pred), torch.as_tensor(real),
                              torch.as_tensor(valid))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6, equal_nan=True)
    if fn == "mean_correlation":
        assert np.isnan(float(got)) == (case in ("all_skipped", "one_row"))
