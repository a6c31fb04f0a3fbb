"""The ViTs' attention (``ops/cuda_vit.py``, kernel ``csrc/vit_attention.cu``)
on the CPU: the plain twin against the block's attention as it was before
the kernel (bit for bit, f32 and bf16) and against the JAX package's
einsums; the route ``models/uni_vit._block`` takes; what the wrapper refuses;
the launch it makes, against a stand-in for the kernel library; and the span
``vit.attn``.  The kernel itself is held against the twin on the card by
``chip_smoke.py`` (its ``vit_attention`` row)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequoia_tpu.ops.nn import einsum as jeinsum
from sequoia_tpu_torch import _build
from sequoia_tpu_torch.models import uni_vit as tuni
from sequoia_tpu_torch.ops import cuda_vit
from sequoia_tpu_torch.utils import profiling
from tests.test_torch_vis_wgmma import fake_lib  # noqa: F401  (fixture)

# (batch, tokens, heads, dh): UNI's heads at its 197 tokens, Virchow2's at
# its 261, then ragged token counts (one token, one past a 64-row tile, a
# prime) at both widths
SHAPES = [(1, 197, 16, 64), (1, 261, 16, 80), (3, 1, 2, 80), (2, 65, 2, 64), (2, 37, 3, 80)]
IDS = ["uni", "virchow2", "n1", "n65", "n37"]


def _qkv(b, n, h, dh, dtype, seed=0):
    g = torch.Generator().manual_seed(seed + n + dh)
    return (2 * torch.randn((b * n, 3 * h * dh), generator=g)).to(dtype)


def _attention_before(qkv, b, n, h, dh):
    """The block's attention as ``models/uni_vit._block`` computed it before
    the kernel, line for line (with its ``_scores``)."""
    qkv = qkv.reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    scale = dh ** -0.5
    exact = math.frexp(scale)[0] == 0.5
    q3 = (q * scale if exact else q).reshape(b * h, n, dh)
    kt = k.reshape(b * h, n, dh).transpose(1, 2)
    s = torch.bmm(q3.float(), kt.float())
    s = (s if exact else s * scale).reshape(b, h, n, n)
    attn = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(attn, v).transpose(1, 2).reshape(b, n, h * dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,n,h,dh", SHAPES, ids=IDS)
def test_plain_twin_is_the_block_attention_bit_for_bit(b, n, h, dh, dtype):
    qkv = _qkv(b, n, h, dh, dtype)
    got = cuda_vit.vit_attention_plain(qkv, b, n, h)
    assert got.shape == (b * n, h * dh) and got.dtype == dtype
    assert torch.equal(got, _attention_before(qkv, b, n, h, dh).reshape(b * n, h * dh))


@pytest.mark.parametrize("b,n,h,dh", SHAPES, ids=IDS)
def test_plain_twin_matches_jax(b, n, h, dh):
    """f32 against the JAX package's attention (sequoia_tpu/models/uni_vit.py
    :65-71, its einsums at HIGHEST precision), within UNI's forward
    tolerance (tests/test_backbones.py:66)."""
    qkv = _qkv(b, n, h, dh, torch.float32, seed=5)
    x = jnp.asarray(qkv.numpy()).reshape(b, n, 3 * h * dh)
    q, k, v = (t.reshape(b, n, h, dh).transpose(0, 2, 1, 3) for t in jnp.split(x, 3, axis=-1))
    scores = jeinsum("bhnd,bhmd->bhnm", q, k) * (dh ** -0.5)
    attn = jnp.exp(scores - scores.max(-1, keepdims=True))
    attn = attn / attn.sum(-1, keepdims=True)
    want = np.asarray(jeinsum("bhnm,bhmd->bhnd", attn, v)).transpose(0, 2, 1, 3)
    got = cuda_vit.vit_attention_plain(qkv, b, n, h).numpy()
    want = want.reshape(b * n, h * dh)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["uni", "virchow2"])
def test_block_takes_the_plain_route_on_the_cpu(monkeypatch, kind, dtype):
    """On the CPU, and in f32 anywhere, ``_block`` runs the plain twin: the
    wrapper is never called and nothing launches."""
    cfg_cls = tuni.UniViTConfig if kind == "uni" else tuni.Virchow2Config
    cfg = cfg_cls(img_size=28, patch_size=14, dim=160, depth=2, heads=2,
                  mlp_dim=320 if kind == "uni" else 854, compute_dtype=dtype)

    def refuse(*a, **kw):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(cuda_vit, "vit_attention", refuse)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    params = tuni.prepare(cfg, tuni.random_params(cfg, torch.Generator().manual_seed(1),
                                                  layer_scale=0.1))
    images = torch.randn((2, 28, 28, 3), generator=torch.Generator().manual_seed(2))
    out = tuni.forward(cfg, params, images)
    assert out.shape == (2, cfg.feature_dim) and bool(torch.isfinite(out).all())
    assert _build.LAUNCHES["vit_attention"] == 0


@pytest.mark.parametrize("dtype, n, dh", [(torch.bfloat16, 197, 64), (torch.float32, 261, 80)],
                         ids=["bf16", "f32"])
def test_takes_is_false_off_the_card(dtype, n, dh):
    assert not cuda_vit.takes(torch.zeros((2, 3 * dh), dtype=dtype), n, dh)


def _unaligned(b, n, h, dh):
    flat = torch.zeros(b * n * 3 * h * dh + 1, dtype=torch.bfloat16)
    return flat[1:].view(b * n, 3 * h * dh)


# what the wrapper refuses, each with the words of its error
REFUSED = {
    "f32": (lambda: torch.zeros((2 * 5, 3 * 2 * 64)), 2, 5, 2, "bf16"),
    "3d": (lambda: torch.zeros((2, 5, 3 * 2 * 64), dtype=torch.bfloat16), 2, 5, 2, "B\\*N"),
    "rows": (lambda: torch.zeros((9, 3 * 2 * 64), dtype=torch.bfloat16), 2, 5, 2, "B\\*N"),
    "cols": (lambda: torch.zeros((10, 3 * 2 * 64 + 2), dtype=torch.bfloat16), 2, 5, 2, "B\\*N"),
    "dh32": (lambda: torch.zeros((10, 3 * 2 * 32), dtype=torch.bfloat16), 2, 5, 2, "dh in"),
    "n513": (lambda: torch.zeros((513, 3 * 64), dtype=torch.bfloat16), 1, 513, 1, "N <="),
    "strided": (lambda: torch.zeros((3 * 2 * 64, 10), dtype=torch.bfloat16).T, 2, 5, 2,
                "contiguous"),
    "unaligned": (lambda: _unaligned(2, 5, 2, 64), 2, 5, 2, "16-byte aligned"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(fake_lib, case):  # noqa: F811
    make, b, n, h, words = REFUSED[case]
    with pytest.raises(ValueError, match=words):
        cuda_vit.vit_attention(make(), b, n, h)
    assert fake_lib.calls == [] and _build.LAUNCHES["vit_attention"] == 0


@pytest.mark.parametrize("b,n,h,dh", SHAPES[:2], ids=IDS[:2])
def test_cuda_route_launches_the_kernel_once(fake_lib, b, n, h, dh):  # noqa: F811
    qkv = _qkv(b, n, h, dh, torch.bfloat16)
    out = cuda_vit._vit_attention_cuda(qkv, b, n, h, dh)
    assert out.shape == (b * n, h * dh) and out.dtype == torch.bfloat16
    [(name, args)] = fake_lib.calls
    assert name == "sq_vit_attention" and len(args) == len(_build._SIGNATURES[name])
    assert args[0] == qkv.data_ptr() and args[1] == out.data_ptr()
    assert args[2:6] == (b, n, h, dh)
    assert args[6] == pytest.approx(dh ** -0.5)
    assert _build.LAUNCHES["vit_attention"] == 1


def test_cpu_tensors_run_the_plain_twin(fake_lib):  # noqa: F811
    qkv = _qkv(2, 37, 3, 80, torch.bfloat16)
    got = cuda_vit.vit_attention(qkv, 2, 37, 3)
    assert fake_lib.calls == [] and _build.LAUNCHES["vit_attention"] == 0
    assert torch.equal(got, cuda_vit.vit_attention_plain(qkv, 2, 37, 3))


@pytest.mark.parametrize("kind", ["uni", "virchow2"])
def test_span_once_per_block_and_batch(kind):
    """Under a profiler each forward records ``vit.attn`` once a block; with
    no profiler, nothing."""
    from torch.profiler import ProfilerActivity, profile

    cfg_cls = tuni.UniViTConfig if kind == "uni" else tuni.Virchow2Config
    cfg = cfg_cls(img_size=28, patch_size=14, dim=160, depth=3, heads=2,
                  mlp_dim=320 if kind == "uni" else 854)
    params = tuni.random_params(cfg, torch.Generator().manual_seed(3))
    images = torch.randn((2, 28, 28, 3), generator=torch.Generator().manual_seed(4))
    profiling.clear()
    tuni.forward(cfg, params, images)
    assert "vit.attn" not in profiling.summary()["spans"]
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.clear()
        for _ in range(2):  # two batches
            tuni.forward(cfg, params, images)
        spans = profiling.summary()["spans"]
    profiling.clear()
    assert spans["vit.attn"]["count"] == 2 * 3
    assert spans["vit.mlp"]["count"] == 2 * 3
