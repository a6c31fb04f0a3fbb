"""The bf16 tensor-core route of K3/K4 (ops/cuda_resnet.py ``_tc_chain`` /
``_wg_gemm``, csrc/conv_wgmma.cu) on the CPU: the wrapper's validation, the
plain version of one launch against the JAX Pallas chain in interpret mode
and against the port's plain chains in both weight orientations, and the
ctypes signatures of every C entry."""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.ops import pallas_resnet as jpr
from sequoia_tpu_torch import _build
from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.ops import cuda_resnet as tpr
from tests.test_torch_resnet import small_params

BF = torch.bfloat16


def _carry(jparams):
    return convert.resnet_params_from_numpy(jax.tree.map(np.asarray, jparams))


def _operands(mode, *, P=12, K=24, N=16, C=8, K1=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    cin = {tpr._PC_TAPS3: C, tpr._PC_CONCAT: K1}.get(mode, K)
    X = torch.randn((2, P, cin), generator=g).to(BF)
    X2 = torch.randn((2, P, K - K1), generator=g).to(BF) if mode == tpr._PC_CONCAT else None
    Wop = torch.randn((K, N), generator=g).to(BF)
    bias = torch.randn((N,), generator=g)
    return X, X2, Wop, bias


# ---------------------------------------------------------------------------
# what the kernel does not take
# ---------------------------------------------------------------------------

def test_wg_gemm_takes_bf16_only():
    X, _, Wop, bias = _operands(tpr._PC_PLAIN)
    with pytest.raises(TypeError, match="bf16"):
        tpr._wg_gemm(tpr._PC_PLAIN, X.float(), Wop, bias, K=24, N=16, kmajor=False,
                     counter="bottleneck_chain")
    with pytest.raises(TypeError, match="bf16"):
        tpr._wg_gemm(tpr._PC_PLAIN, X, Wop.float(), bias, K=24, N=16, kmajor=False,
                     counter="bottleneck_chain")


@pytest.mark.parametrize("mode,kw,match", [
    (tpr._PC_TAPS3, dict(K=108, N=16, C=12), "C % 8"),       # 12 channels: no 16-byte chunks
    (tpr._PC_TAPS3, dict(K=64, N=16, C=8), "K == 9\\*C"),
    (tpr._PC_PLAIN, dict(K=20, N=16), "multiples of 8"),
    (tpr._PC_PLAIN, dict(K=24, N=12), "multiples of 8"),
    (tpr._PC_CONCAT, dict(K=24, N=16, K1=4), "concat split"),
    (tpr._PC_CONCAT, dict(K=24, N=16, K1=24), "concat split"),
], ids=["taps_c12", "taps_k", "k20", "n12", "k1_4", "k1_k"])
def test_wg_gemm_rejects_shapes(mode, kw, match):
    C = kw.get("C", 8)
    X = torch.zeros((1, 8, C if mode == tpr._PC_TAPS3 else kw.get("K1") or kw["K"]), dtype=BF)
    X2 = torch.zeros((1, 8, 8), dtype=BF) if mode == tpr._PC_CONCAT else None
    Wop = torch.zeros((kw["K"], kw["N"]), dtype=BF)
    bias = torch.zeros((kw["N"],))
    with pytest.raises(ValueError, match=match):
        tpr._wg_gemm(mode, X, Wop, bias, kmajor=False, counter="bottleneck_chain", X2=X2,
                     W=4, **kw)


def test_wg_gemm_rejects_layouts():
    X, _, Wop, bias = _operands(tpr._PC_PLAIN)
    kw = dict(K=24, N=16, kmajor=False, counter="bottleneck_chain")
    with pytest.raises(ValueError, match="contiguous"):
        tpr._wg_gemm(tpr._PC_PLAIN, X.transpose(0, 1), Wop, bias, **kw)
    shifted = torch.zeros(X.numel() + 1, dtype=BF)[1:].view(X.shape)  # 2-byte offset
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpr._wg_gemm(tpr._PC_PLAIN, shifted, Wop, bias, **kw)
    with pytest.raises(ValueError, match="bias"):
        tpr._wg_gemm(tpr._PC_PLAIN, X, Wop, bias[:8].contiguous(), **kw)


# ---------------------------------------------------------------------------
# the plain version of one launch and the chain driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [tpr._PC_PLAIN, tpr._PC_TAPS3, tpr._PC_CONCAT],
                         ids=["plain", "taps3", "concat"])
def test_kmajor_weights_give_the_same_gemm(mode):
    """K3's (N, K) weights read K-major give K4's (K, N) GEMM, and the (C, P)
    output is its transpose."""
    K = 72 if mode == tpr._PC_TAPS3 else 24
    X, X2, Wop, bias = _operands(mode, K=K)
    R = torch.randn((2, 12, 16), generator=torch.Generator().manual_seed(1)).to(BF)
    kw = dict(K=K, N=16, W=4, C=8, X2=X2, R=R if mode == tpr._PC_PLAIN else None,
              K1=8 if mode == tpr._PC_CONCAT else 0, counter="bottleneck_chain")
    before = dict(_build.LAUNCHES)
    mn = tpr._wg_gemm(mode, X, Wop, bias, kmajor=False, **kw)
    km = tpr._wg_gemm(mode, X, Wop.t().contiguous(), bias, kmajor=True, **kw)
    cp = tpr._wg_gemm(mode, X, Wop.t().contiguous(), bias, kmajor=True, out_cp=True, **kw)
    assert _build.LAUNCHES == before  # CPU tensors run the plain version
    assert mn.dtype == BF and mn.shape == (2, 12, 16) and cp.shape == (2, 16, 12)
    torch.testing.assert_close(km, mn, rtol=0, atol=0)
    torch.testing.assert_close(cp, mn.transpose(1, 2), rtol=0, atol=0)


@pytest.mark.parametrize("H,W", [(8, 8), (5, 7)])
def test_tc_chain_matches_jax_interpret_bf16(H, W):
    """The tensor-core route's plain version against the Pallas chain, bf16
    operands and activations on both sides."""
    jblocks = small_params(jax.random.PRNGKey(6))
    x = np.array(jax.random.normal(jax.random.PRNGKey(7), (2, H * W, 8)))
    flat, meta = jpr.stage_chain_weights(jblocks, 0, jnp.bfloat16)
    want = np.asarray(jpr.bottleneck_chain(jnp.asarray(x, jnp.bfloat16), flat, meta=meta,
                                           H=H, W=W, row_chunk=H * W, interpret=True)
                      ).astype(np.float32)
    tflat, tmeta = tpr.stage_chain_weights(_carry(jblocks), 0, BF)
    got = tpr._tc_chain(torch.as_tensor(x).to(BF), tflat, meta=tmeta, W=W, kmajor=False,
                        counter="bottleneck_chain").float().numpy()
    # bf16 rounds y1, y2 and each block output; one rounding step apart at most
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("H,W", [(8, 8), (4, 12), (5, 7)])
def test_tc_chain_matches_plain_chains(H, W):
    """K4's weights (MN-major B) give bottleneck_chain_plain exactly; K3's
    (K-major B), with the last launch writing the (C, P) layout, give
    bottleneck_chain_cp_plain up to f32 summation order."""
    blocks = _carry(small_params(jax.random.PRNGKey(8), nblocks=3))
    x = torch.relu(torch.randn((3, H * W, 8), generator=torch.Generator().manual_seed(2))
                   ).to(BF)
    flat, meta = tpr.stage_chain_weights(blocks, 0, BF)
    cflat, _ = tpr.stage_chain_weights_cp(blocks, 0, BF)
    pc = tpr._tc_chain(x, flat, meta=meta, W=W, kmajor=False, counter="bottleneck_chain")
    torch.testing.assert_close(pc, tpr.bottleneck_chain_plain(x, flat, meta=meta, H=H, W=W),
                               rtol=0, atol=0)
    cp = tpr._tc_chain(x, cflat, meta=meta, W=W, kmajor=True, out_cp=True,
                       counter="bottleneck_chain_cp")
    want = tpr.bottleneck_chain_cp_plain(x.transpose(1, 2).contiguous(), cflat, meta=meta,
                                         H=H, W=W)
    assert cp.shape == want.shape and cp.is_contiguous()
    torch.testing.assert_close(cp.float(), want.float(), rtol=0,
                               atol=1e-2 * float(want.float().abs().max()))


def test_tc_chain_keeps_the_identity_check():
    blocks = _carry(small_params(jax.random.PRNGKey(9)))
    flat, meta = tpr.stage_chain_weights(blocks, 1, BF)
    bad = ((meta[0][0], meta[0][1], meta[0][2] // 2, False),)  # cin != cout, no projection
    x = torch.zeros((1, 16, meta[0][0]), dtype=BF)
    w3 = flat[4][:, :meta[0][2] // 2].contiguous()
    b3 = flat[5][:, :meta[0][2] // 2].contiguous()
    with pytest.raises(ValueError, match="cin == cout"):
        tpr._tc_chain(x, (*flat[:4], w3, b3), meta=bad, W=4, kmajor=False,
                      counter="bottleneck_chain")


# ---------------------------------------------------------------------------
# the C entries' ctypes signatures
# ---------------------------------------------------------------------------

_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


def _c_entries():
    """name -> the ctypes type of each argument, from every extern "C" entry
    of csrc/*.cu: a pointer is c_void_p, else the C integer type."""
    entries = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for name, args in re.findall(r'extern "C" int (sq_\w+)\(([^)]*)\)', text):
            types = []
            for arg in " ".join(args.split()).split(","):
                decl = arg.strip().rsplit(" ", 1)[0].replace("const ", "").strip()
                types.append(ctypes.c_void_p if "*" in arg else _C_TYPES[decl])
            entries[name] = types
    return entries


def test_every_c_entry_has_a_matching_signature():
    entries = _c_entries()
    assert "sq_pc_wgmma" in entries and len(entries) >= 5
    assert set(entries) == set(_build._SIGNATURES)
    for name, types in entries.items():
        assert _build._SIGNATURES[name] == types, name
