"""The port's whole ResNet-50 extractor with the kernel stage options
(``fused_stages`` through K4, ``early_pallas`` + ``cp_stages`` through K2/K3)
against the JAX package's on the CPU, Pallas kernels in interpret mode
(tolerances of tests/test_pallas_resnet.py:135-149)."""

import numpy as np
import pytest
import torch

import jax

from sequoia_tpu.models import resnet as jresnet
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.models import resnet as tresnet


@pytest.mark.parametrize("opts", [dict(fused_stages=(1, 2, 3, 4)),
                                  dict(early_pallas=True, cp_stages=(2, 3, 4))],
                         ids=["fused_stages", "early_cp_stages"])
def test_extract_from_uint8_stage_options_match_jax(opts):
    jp = jresnet.random_params(jax.random.PRNGKey(0))
    imgs = np.random.default_rng(0).integers(0, 256, size=(1, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(jresnet.extract_from_uint8(jresnet.ResNetConfig(**opts), jp, imgs))
    tp = convert.resnet_params_from_numpy(jax.tree.map(np.asarray, jp))
    got = tresnet.extract_from_uint8(tresnet.ResNetConfig(**opts), tp,
                                     torch.as_tensor(imgs)).numpy()
    assert got.shape == (1, 2048)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-2)
