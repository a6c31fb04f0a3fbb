"""The f32 K2 ``stem16`` and K3 ``bottleneck_chain_cp`` on the tensor cores
(``csrc/stem_wgmma.cu`` ``stem_tf32_kernel``, ``csrc/conv_wgmma.cu``
``pc_tf32_kernel`` with a K-major B and the (C, P) epilogue) on the CPU.

Both kernels take every product as 3xTF32 (hi.hi + hi.lo + lo.hi of each
operand's TF32 split) and add each 32-deep K slab's products to the running
f32 sum with a rounded add.  :func:`tf32x3_slabs` emulates that in numpy
(``rna``/``split``/``tf32x3`` of ``tests/test_torch_tf32x3.py``) and holds
it against float64 and JAX's ``Precision.HIGHEST`` f32 dot at the stem's
(64, 256) . (256, P) product and K3's three GEMMs in the (C_out, K)
orientation.  Then the stem kernel's slab walk, the plain versions in f64
(the card's reference), the f32 wrappers against a stand-in library, K3's
f32 chain route on the CPU, and the plain versions against the Pallas
kernels in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.models import resnet as jresnet
from sequoia_tpu.ops import pallas_resnet as jpr
from sequoia_tpu_torch import _build
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.models import resnet as tresnet
from sequoia_tpu_torch.ops import cuda_resnet as tpr
from tests.test_torch_resnet import small_params
from tests.test_torch_stem_wgmma import _x16
from tests.test_torch_tf32x3 import REL_TOL, highest, rel, tf32x3
from tests.test_torch_vis_wgmma import fake_lib  # noqa: F401  (fixture)

SLAB = 32  # K values per slab of the kernels: one 128-byte swizzle row of f32


def tf32x3_slabs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M, K) . (K, N) as the f32 kernels form it: each 32-deep slab's
    3xTF32 products summed on their own, then added to the running f32 sum
    (per-slab promotion)."""
    acc = np.zeros((a.shape[0], b.shape[1]), dtype=np.float32)
    for k0 in range(0, a.shape[1], SLAB):
        acc = (acc + tf32x3(a[:, k0:k0 + SLAB], b[k0:k0 + SLAB])).astype(np.float32)
    return acc


def _carry(jparams):
    return convert.resnet_params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def stem_weights():
    jp = jresnet.random_params(jax.random.PRNGKey(0))
    return jp, _carry(jp)


def _stem_stack(x16: torch.Tensor, H2: int, W2: int) -> torch.Tensor:
    """stem16_plain's (B, 256, P) tap stack: row (ky*4 + kx)*16 + c."""
    P = H2 * W2
    return torch.cat([tpr._shifted(x16[:, :, ky * W2:ky * W2 + P], W2, 0, dx)
                      for ky in range(4) for dx in (-2, -1, 0, 1)], dim=1)


# ---------------------------------------------------------------------------
# the recipe at the two kernels' GEMM shapes
# ---------------------------------------------------------------------------

def _operands(kind: str, stem_weights, P: int = 128):
    """(A (M, K), B (K, N)) as the kernel multiplies them: the stem's folded
    weights by its tap stack; K3's (P, K) activations by its (C_out, K)
    weights, read K-major (B = W^T)."""
    g = np.random.default_rng(len(kind))
    if kind == "stem":
        _, tp = stem_weights
        a, _ = tpr.fold_stem16_weights(tp["conv1_s2d"], tp["bn1"], torch.float32)
        x16 = torch.as_tensor(_x16(1, 8, 16, seed=3))
        return a.numpy(), _stem_stack(x16, 8, 16)[0].numpy()

    def relu(*s):
        return np.maximum(g.normal(size=s), 0).astype(np.float32)

    def weights(n, k):  # (C_out, K), as stage_chain_weights_cp folds them
        return (g.normal(size=(n, k)) * np.sqrt(2.0 / k)).astype(np.float32)

    if kind == "conv1":  # layer1's identity block: 256 -> 64
        return relu(P, 256), weights(64, 256).T.copy()
    if kind == "taps3":  # the (P, 9 * 64) tap stack of y1
        y1 = torch.as_tensor(relu(1, P, 64))
        stack = torch.cat([tpr._shifted(y1, 8, dy, dx, dim=-2) for dy, dx in tpr.TAPS],
                          dim=-1)[0].numpy()
        return stack, weights(64, 9 * 64).T.copy()
    # [W3 | Wd] on [y2 | x]: layer1's projection block, 64 + 64 -> 256
    return np.concatenate([relu(P, 64), relu(P, 64)], axis=1), weights(256, 128).T.copy()


@pytest.mark.parametrize("kind", ["stem", "conv1", "taps3", "concat"])
def test_slab_promoted_tf32x3_against_f64_and_jax_highest(kind, stem_weights):
    a, b = _operands(kind, stem_weights)
    want = a.astype(np.float64) @ b.astype(np.float64)
    emu, jx = tf32x3_slabs(a, b), highest(a, b)
    assert rel(emu, want) < REL_TOL and rel(jx, want) < REL_TOL
    assert rel(emu, jx.astype(np.float64)) < 2 * REL_TOL
    # promotion changes only the order of f32 additions of the same products
    assert rel(emu, tf32x3(a, b).astype(np.float64)) < REL_TOL


def test_slab_promoted_rows_do_not_depend_on_their_place(stem_weights):
    """Every output is one fixed-order reduction, whatever its tile: moving
    the pixels moves the product bit for bit."""
    a, b = _operands("stem", stem_weights)
    np.testing.assert_array_equal(tf32x3_slabs(a, np.roll(b, 64, axis=1)),
                                  np.roll(tf32x3_slabs(a, b), 64, axis=1))


# ---------------------------------------------------------------------------
# the stem kernel's slab walk
# ---------------------------------------------------------------------------

def _kernel_slab(x16: np.ndarray, s: int, H2: int, W2: int) -> np.ndarray:
    """(32, P) slab s as stem_tf32_kernel gathers it: thread half h takes tap
    (ky, kx) = (s // 2, 2 (s % 2) + h), channels 0..15, at every pixel q,
    x16[c, ky*W2 + q + dx] with dx = kx - 2, zero where q % W2 + dx leaves
    the row."""
    P = H2 * W2
    q = np.arange(P)
    rows = []
    for h in range(2):
        ky, dx = s // 2, 2 * (s % 2) + h - 2
        col = q % W2 + dx
        ok = (col >= 0) & (col < W2)
        src = np.clip(ky * W2 + q + dx, 0, x16.shape[1] - 1)
        rows.append(np.where(ok[None, :], x16[:, src], 0))
    return np.concatenate(rows)


@pytest.mark.parametrize("H2,W2", [(8, 16), (5, 24)], ids=["8x16", "5x24"])
def test_stem_kernel_slabs_are_the_plain_stack(H2, W2):
    x16 = _x16(1, H2, W2, seed=H2)[0]
    stack = _stem_stack(torch.as_tensor(x16)[None], H2, W2)[0].numpy()
    for s in range(256 // SLAB):
        np.testing.assert_array_equal(_kernel_slab(x16, s, H2, W2),
                                      stack[s * SLAB:(s + 1) * SLAB])


# ---------------------------------------------------------------------------
# the plain versions in f64 (the card's reference), f32 unchanged
# ---------------------------------------------------------------------------

def test_stem_plain_runs_in_f64(stem_weights):
    _, tp = stem_weights
    a, b = tpr.fold_stem16_weights(tp["conv1_s2d"], tp["bn1"], torch.float32)
    x16 = torch.as_tensor(_x16(2, 8, 16, seed=5))
    got32 = tpr.stem16_plain(x16, a, b, H2=8, W2=16)
    got64 = tpr.stem16_plain(x16.double(), a.double(), b.double(), H2=8, W2=16)
    assert got32.dtype == torch.float32 and got64.dtype == torch.float64
    assert 0 < rel(got32.numpy(), got64.numpy()) < 1e-6
    # the CPU route of the public function is the plain version, bit for bit
    torch.testing.assert_close(tpr.stem16(x16, a, b, H2=8, W2=16), got32, rtol=0, atol=0)


def _cp_chain(dtype):
    params = tresnet.random_params(torch.Generator().manual_seed(0))
    flat, meta = tpr.stage_chain_weights_cp(params["layer4"], 1, torch.float32)
    x = torch.relu(torch.randn((1, 2048, 64), generator=torch.Generator().manual_seed(1)))
    return x.to(dtype), tuple(t.to(dtype) for t in flat), meta


def test_chain_cp_plain_runs_in_f64():
    x, flat, meta = _cp_chain(torch.float32)
    x64, flat64, _ = _cp_chain(torch.float64)
    got32 = tpr.bottleneck_chain_cp_plain(x, flat, meta=meta, H=8, W=8)
    got64 = tpr.bottleneck_chain_cp_plain(x64, flat64, meta=meta, H=8, W=8)
    assert got32.dtype == torch.float32 and got64.dtype == torch.float64
    assert 0 < rel(got32.numpy(), got64.numpy()) < 1e-5
    torch.testing.assert_close(tpr.bottleneck_chain_cp(x, flat, meta=meta, H=8, W=8), got32,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the f32 wrappers against a stand-in library
# ---------------------------------------------------------------------------

@pytest.fixture
def on_card(monkeypatch):
    """Every tensor reports ``is_cuda``, so the public functions take their
    kernel routes into the stand-in library on CPU tensors."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


def test_stem16_f32_calls_the_tf32_entry(fake_lib, on_card, stem_weights):  # noqa: F811
    _, tp = stem_weights
    a, b = tpr.fold_stem16_weights(tp["conv1_s2d"], tp["bn1"], torch.float32)
    x16 = torch.as_tensor(_x16(3, 8, 16, seed=0))
    out = tpr.stem16(x16, a, b, H2=8, W2=16)
    assert out.shape == (3, 64, 128) and out.dtype == torch.float32
    [(name, args)] = fake_lib.calls
    assert name == "sq_stem_tf32" and len(args) == len(_build._SIGNATURES[name])
    assert args[:4] == (x16.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr())
    assert args[4:7] == (3, 8, 16)  # B, H2, W2
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0) | {"stem16": 1}


def test_stem16_f32_refuses_before_any_call(fake_lib, stem_weights):  # noqa: F811
    _, tp = stem_weights
    a, b = tpr.fold_stem16_weights(tp["conv1_s2d"], tp["bn1"], torch.float32)
    with pytest.raises(ValueError, match="W2 % 8"):
        tpr._stem16_cuda(torch.zeros((1, 16, 11 * 12)), a, b, H2=8, W2=12)
    nc = torch.zeros((1, 11 * 16, 16)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tpr._stem16_cuda(nc, a, b, H2=8, W2=16)
    unaligned = torch.zeros(16 * 11 * 16 + 1)[1:].view(1, 16, 176)  # 4-byte offset
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpr._stem16_cuda(unaligned, a, b, H2=8, W2=16)
    with pytest.raises(TypeError, match="takes f32"):
        tpr._stem_wgmma_check(torch.zeros((1, 16, 176)), a.bfloat16(), b, W2=16,
                              dtype=torch.float32)
    assert fake_lib.calls == [] and _build.LAUNCHES["stem16"] == 0


def test_chain_cp_f32_calls_the_tf32_entry_k_major(fake_lib, on_card):  # noqa: F811
    """Layer1 (a projection block, then two identity blocks): three
    ``sq_pc_tf32`` launches a block, every one with a K-major B, only the
    last writing the (C, P) layout."""
    params = tresnet.random_params(torch.Generator().manual_seed(0))
    flat, meta = tpr.stage_chain_weights_cp(params["layer1"], 0, torch.float32)
    x = torch.zeros((2, 64, 8 * 8))
    out = tpr.bottleneck_chain_cp(x, flat, meta=meta, H=8, W=8)
    assert out.shape == (2, 256, 64)
    calls = fake_lib.calls
    assert [name for name, _ in calls] == ["sq_pc_tf32"] * 9
    sig = _build._SIGNATURES["sq_pc_tf32"]
    assert all(len(args) == len(sig) for _, args in calls)
    modes = [args[0] for _, args in calls]
    assert modes == [tpr._PC_PLAIN, tpr._PC_TAPS3, tpr._PC_CONCAT] + \
        [tpr._PC_PLAIN, tpr._PC_TAPS3, tpr._PC_PLAIN] * 2
    assert all(args[1] == 1 for _, args in calls)  # b_kmajor
    assert [args[15] for _, args in calls] == [0] * 8 + [1]  # out_cp
    # M, P, K, K1, N, W, C of the projection block's three launches (W and C
    # matter to the 3x3 taps only)
    assert [args[8:15] for _, args in calls[:3]] == [
        (128, 64, 64, 0, 64, 1, 0), (128, 64, 576, 0, 64, 8, 64),
        (128, 64, 128, 64, 256, 1, 0)]
    assert calls[-1][1][7] == out.data_ptr()
    assert _build.LAUNCHES["bottleneck_chain_cp"] == 9
    assert _build.LAUNCHES["bottleneck_chain"] == 0


def test_tf32_gemm_k_major_refuses_before_any_call(fake_lib):  # noqa: F811
    g = torch.Generator().manual_seed(0)
    X = torch.randn((2, 12, 24), generator=g)
    w_nk, bias = torch.randn((16, 24), generator=g), torch.randn((16,), generator=g)
    kw = dict(K=24, N=16, kmajor=True, counter="bottleneck_chain_cp", out_cp=True)
    with pytest.raises(TypeError, match="f32"):
        tpr._tf32_gemm(tpr._PC_PLAIN, X, w_nk.bfloat16(), bias, **kw)
    with pytest.raises(ValueError, match=r"\(N, K\)"):  # K4's (K, N) orientation
        tpr._tf32_gemm(tpr._PC_PLAIN, X, w_nk.t().contiguous(), bias, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tpr._tf32_gemm(tpr._PC_PLAIN, X, torch.randn((24, 16)).t(), bias, **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        shifted = torch.zeros(X.numel() + 1)[1:].view(X.shape)
        tpr._tf32_gemm(tpr._PC_PLAIN, shifted, w_nk, bias, **kw)
    assert fake_lib.calls == [] and _build.LAUNCHES["bottleneck_chain_cp"] == 0
    # on the CPU: the plain launch, transposed out, nothing counted
    got = tpr._tf32_gemm(tpr._PC_PLAIN, X, w_nk, bias, **kw)
    assert got.shape == (2, 16, 12) and fake_lib.calls == []
    torch.testing.assert_close(got, torch.relu(X @ w_nk.t() + bias).transpose(1, 2),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K3's f32 route on the CPU, and the plain versions against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W", [(8, 8), (5, 7)])
def test_chain_cp_f32_route_matches_plain_and_jax_interpret(H, W):
    """The route K3 f32 takes on the card (a transpose in, K4's GEMMs with
    the (C_out, K) weights K-major, the last launch in the (C, P) layout),
    run by its plain launches, against bottleneck_chain_cp_plain (f32
    summation order apart) and the Pallas chain in interpret mode."""
    jblocks = small_params(jax.random.PRNGKey(11), nblocks=3)
    x = np.maximum(np.asarray(jax.random.normal(jax.random.PRNGKey(12), (2, 8, H * W))), 0)
    flat, meta = jpr.stage_chain_weights_cp(jblocks, 0, jnp.float32)
    want = np.asarray(jpr.bottleneck_chain_cp(jnp.asarray(x), flat, meta=meta, H=H, W=W,
                                              interpret=True))
    tflat, tmeta = tpr.stage_chain_weights_cp(_carry(jblocks), 0, torch.float32)
    xt = torch.as_tensor(x)
    got = tpr._tc_chain(xt.transpose(1, 2).contiguous(), tflat, meta=tmeta, W=W, kmajor=True,
                        out_cp=True, counter="bottleneck_chain_cp")
    plain = tpr.bottleneck_chain_cp_plain(xt, tflat, meta=tmeta, H=H, W=W)
    assert got.shape == plain.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5 * float(plain.abs().max()))
    # tests/test_pallas_resnet.py: test_chain_cp_matches_xla
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H2,W2", [(2, 8, 16), (1, 5, 24)], ids=["8x16", "5x24"])
def test_stem_plain_f32_matches_jax_interpret(stem_weights, B, H2, W2):
    jp, tp = stem_weights
    x16 = _x16(B, H2, W2, seed=B * W2)
    a, bias = jpr.fold_stem16_weights(jp["conv1_s2d"], jp["bn1"], jnp.float32)
    want = np.asarray(jpr.stem16(jnp.asarray(x16), a, bias, H2=H2, W2=W2, interpret=True))
    ta, tbias = tpr.fold_stem16_weights(tp["conv1_s2d"], tp["bn1"], torch.float32)
    got = tpr.stem16_plain(torch.as_tensor(x16), ta, tbias, H2=H2, W2=W2)
    # tests/test_pallas_resnet.py: test_stem16_matches_s2d_conv
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
