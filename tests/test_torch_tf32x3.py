"""The f32 kernels' 3xTF32 recipe (K4 ``conv_wgmma.cu`` ``pc_tf32_kernel``,
K1 ``vis_wgmma.cu`` ``vis_tf32_gemm``) on the CPU.

The card's kernels split every f32 operand v into TF32 hi = rna(v) and
lo = rna(v - hi) (``cvt.rna.tf32.f32``) and add hi.hi + hi.lo + lo.hi into
one f32 accumulator.  :func:`tf32x3` emulates that product in numpy (this
file's own, used by no module) and holds it against float64 and against
JAX's ``Precision.HIGHEST`` f32 ``jnp.dot`` (the TPU kernels' f32 recipe,
``pallas_resnet.py:85``, ``pallas_vis.py:206``) at K4's GEMM shapes (1x1,
9-tap stack, merged projection) and K1's (swapped, block-diagonal combine).
The card's tensor cores also truncate as they accumulate; ``chip_smoke.py``
measures that against an f64 run of the plain versions, which the last
tests here check run in f64.  Also the f32 routes' wrappers: what they
refuse, which C entry they call, and the offline CLIs' K4 stage line."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu_torch import _build
from sequoia_tpu_torch.cli import compute_features as tcf
from sequoia_tpu_torch.models import vis as tvis
from sequoia_tpu_torch.ops import cuda_kmeans, cuda_resnet as tpr, cuda_vis as tpv

# max |tf32x3 - f64| / max |f64| over these shapes: the dropped lo.lo term
# and the split's remainder are each ~2^-22 of a product, and f32
# accumulation adds ~sqrt(K) 2^-24; JAX's HIGHEST f32 dot is f32-exact too
REL_TOL = 2e-6


def rna(v: np.ndarray) -> np.ndarray:
    """f32 -> TF32 (10 explicit mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: half of the 13 dropped bits is added
    to the magnitude, then they are cleared."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(v: np.ndarray):
    hi = rna(v)
    return hi, rna((v - hi).astype(np.float32))


def tf32x3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M, K) . (K, N) as the kernels form it: hi.hi + hi.lo + lo.hi, each
    product exact in f32 (11 x 11 bits), summed in f32."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (ah @ bh + ah @ bl + al @ bh).astype(np.float32)


def highest(a, b) -> np.ndarray:
    return np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b),
                              precision=jax.lax.Precision.HIGHEST,
                              preferred_element_type=jnp.float32))


def rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the rounding and the split
# ---------------------------------------------------------------------------

def test_rna_rounds_ties_away_from_zero_and_matches_the_port():
    one = np.float32(1.0)
    half_ulp = np.float32(2.0 ** -11)  # half a TF32 ulp at 1.0
    v = np.array([one + half_ulp, -(one + half_ulp), one + half_ulp / 2,
                  one + 3 * half_ulp, 3.0, 0.0], dtype=np.float32)
    got = rna(v)
    np.testing.assert_array_equal(got, np.array(
        [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 1 + 2.0 ** -9, 3.0, 0.0], dtype=np.float32))
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32) * 100
    assert (x.view(np.uint32) != rna(x).view(np.uint32)).any()
    assert not (rna(x).view(np.uint32) & np.uint32(0x1FFF)).any()
    # the port's K5 mirror rounds the same way
    np.testing.assert_array_equal(cuda_kmeans.tf32_round(torch.as_tensor(x)).numpy(), rna(x))


def test_split_keeps_22_bits():
    x = np.random.default_rng(1).normal(size=(256, 256)).astype(np.float32)
    hi, lo = split(x)
    resid = x.astype(np.float64) - hi - lo
    assert np.abs(resid).max() <= 2.0 ** -21 * np.abs(x).max()
    assert np.abs(resid / np.where(x == 0, 1, x)).max() <= 2.0 ** -21


# ---------------------------------------------------------------------------
# K4's GEMM shapes: (P, C) activations after ReLU, folded (K, C_out) weights
# ---------------------------------------------------------------------------

def _k4_operands(kind: str, seed: int, P: int = 256, W: int = 16):
    g = np.random.default_rng(seed)
    def relu(*s):
        return np.maximum(g.normal(size=s), 0).astype(np.float32)

    def weights(k, n):
        return (g.normal(size=(k, n)) * np.sqrt(2.0 / k)).astype(np.float32)

    if kind == "conv1":  # layer1's first 1x1 of an identity block: 256 -> 64
        return relu(P, 256), weights(256, 64)
    if kind == "taps3":  # the (P, 9 * 64) tap stack, zero where a tap leaves the map
        y1 = torch.as_tensor(relu(1, P, 64))
        stack = torch.cat([tpr._shifted(y1, W, dy, dx, dim=-2) for dy, dx in tpr.TAPS],
                          dim=-1)[0].numpy()
        return stack, weights(9 * 64, 64)
    # conv3 and the projection shortcut as one GEMM: [y2 | x] . [W3; Wd]
    return np.concatenate([relu(P, 64), relu(P, 64)], axis=1), weights(128, 256)


@pytest.mark.parametrize("kind", ["conv1", "taps3", "concat"])
def test_k4_shapes_tf32x3_against_f64_and_jax_highest(kind):
    a, b = _k4_operands(kind, seed=len(kind))
    want = a.astype(np.float64) @ b.astype(np.float64)
    emu, jx = tf32x3(a, b), highest(a, b)
    assert rel(emu, want) < REL_TOL and rel(jx, want) < REL_TOL
    assert rel(emu, jx.astype(np.float64)) < 2 * REL_TOL
    # one TF32 product alone keeps ~11 bits: far outside the f32 recipe
    assert rel(rna(a) @ rna(b), want) > 50 * REL_TOL


def test_k4_rows_do_not_depend_on_their_place():
    """Every output row is one fixed-order K reduction: rotating the rows
    rotates the product bit for bit (the property phase 12 relies on)."""
    a, b = _k4_operands("taps3", seed=3)
    np.testing.assert_array_equal(tf32x3(np.roll(a, 64, axis=0), b),
                                  np.roll(tf32x3(a, b), 64, axis=0))


# ---------------------------------------------------------------------------
# K1's GEMM shapes: swapped (W^T . act^T) over D = 2048, and the
# block-diagonal combine
# ---------------------------------------------------------------------------

def test_k1_swapped_gemm_tf32x3_against_f64_and_jax_highest():
    g = np.random.default_rng(4)
    act = g.normal(size=(100, 2048)).astype(np.float32)  # 100 tokens, K = D
    w = (g.normal(size=(2048, 64)) * 0.02).astype(np.float32)  # 64 output features
    want = (w.T.astype(np.float64) @ act.T.astype(np.float64)).T
    emu = tf32x3(w.T.copy(), act.T.copy()).T
    assert rel(emu, want) < REL_TOL and rel(highest(act, w), want) < REL_TOL
    # split over K as a cluster of 8 sums its partials in rank order
    parts = [tf32x3(w[r * 256:(r + 1) * 256].T.copy(), act[:, r * 256:(r + 1) * 256].T.copy())
             for r in range(8)]
    total = parts[0]
    for p in parts[1:]:
        total = (total + p).astype(np.float32)
    assert rel(total.T, want) < REL_TOL


def test_k1_block_diagonal_combine_tf32x3():
    g = np.random.default_rng(5)
    p, hw = 256, 64
    w = np.zeros((p, p), dtype=np.float32)
    for h in range(p // hw):
        sl = slice(h * hw, (h + 1) * hw)
        w[sl, sl] = g.normal(size=(hw, hw)) * 0.1
    local = g.normal(size=(100, p)).astype(np.float32)
    want = local.astype(np.float64) @ w.astype(np.float64)
    # the kernel takes each 64-feature tile's own heads' rows only
    emu = np.concatenate([tf32x3(local[:, n0:n0 + 64], w[n0:n0 + 64, n0:n0 + 64])
                          for n0 in range(0, p, 64)], axis=1)
    assert rel(emu, want) < REL_TOL and rel(highest(local, w), want) < REL_TOL


# ---------------------------------------------------------------------------
# the plain versions in f64 (chip_smoke.py's reference), f32 unchanged
# ---------------------------------------------------------------------------

def _chain(dtype):
    from sequoia_tpu_torch.models import resnet

    params = resnet.random_params(torch.Generator().manual_seed(0))
    flat, meta = tpr.stage_chain_weights(params["layer4"], 1, torch.float32)
    x = torch.relu(torch.randn((1, 64, 2048), generator=torch.Generator().manual_seed(1)))
    return x.to(dtype), tuple(t.to(dtype) for t in flat), meta


def test_chain_plain_runs_in_f64():
    x, flat, meta = _chain(torch.float32)
    x64, flat64, _ = _chain(torch.float64)
    got32 = tpr.bottleneck_chain_plain(x, flat, meta=meta, H=8, W=8)
    got64 = tpr.bottleneck_chain_plain(x64, flat64, meta=meta, H=8, W=8)
    assert got32.dtype == torch.float32 and got64.dtype == torch.float64
    assert 0 < rel(got32.numpy(), got64.numpy()) < 1e-5
    # the CPU route of the public function is the plain version, bit for bit
    torch.testing.assert_close(tpr.bottleneck_chain(x, flat, meta=meta, H=8, W=8, row_chunk=64),
                               got32, rtol=0, atol=0)


def test_vis_plain_runs_in_f64():
    cfg = tvis.ViSConfig(num_outputs=8, input_dim=512, depth=2, nheads=4, dim_f=64,
                         dim_s=64, dim_c=64, num_clusters=10)
    chunks, smalls, pos = tpv.pack_vis_blocks(cfg, tvis.init(cfg, torch.Generator()
                                                                 .manual_seed(0)),
                                              torch.float32)
    x = torch.randn((10, 512), generator=torch.Generator().manual_seed(1))
    kw = dict(depth=2, nheads=4)
    got32 = tpv.vis_blocks_plain(x, pos, chunks, smalls, **kw)
    got64 = tpv.vis_blocks_plain(x.double(), pos.double(), chunks.double(), smalls.double(),
                                 **kw)
    assert got32.dtype == torch.float32 and got64.dtype == torch.float64
    assert 0 < rel(got32.numpy(), got64.numpy()) < 1e-5


# ---------------------------------------------------------------------------
# the f32 routes' wrappers
# ---------------------------------------------------------------------------

def _pc(mode, *, P=12, K=24, N=16, C=8, K1=8, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    cin = {tpr._PC_TAPS3: C, tpr._PC_CONCAT: K1}.get(mode, K)
    X = torch.randn((2, P, cin), generator=g).to(dtype)
    X2 = torch.randn((2, P, K - K1), generator=g).to(dtype) if mode == tpr._PC_CONCAT else None
    return X, X2, torch.randn((K, N), generator=g).to(dtype), torch.randn((N,), generator=g)


def test_tf32_gemm_takes_f32_only():
    X, _, Wop, bias = _pc(tpr._PC_PLAIN)
    kw = dict(K=24, N=16, counter="bottleneck_chain")
    with pytest.raises(TypeError, match="f32"):
        tpr._tf32_gemm(tpr._PC_PLAIN, X.bfloat16(), Wop, bias, **kw)
    with pytest.raises(TypeError, match="f32"):
        tpr._tf32_gemm(tpr._PC_PLAIN, X, Wop.bfloat16(), bias, **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        shifted = torch.zeros(X.numel() + 1)[1:].view(X.shape)  # 4-byte offset
        tpr._tf32_gemm(tpr._PC_PLAIN, shifted, Wop, bias, **kw)
    with pytest.raises(ValueError, match=r"\(K, N\)"):  # K3's (N, K) orientation
        tpr._tf32_gemm(tpr._PC_PLAIN, X, Wop.t().contiguous(), bias, **kw)


@pytest.mark.parametrize("mode,kw,match", [
    (tpr._PC_TAPS3, dict(K=54, N=16, C=6), "C % 4"),
    (tpr._PC_TAPS3, dict(K=64, N=16, C=8), "K == 9\\*C"),
    (tpr._PC_PLAIN, dict(K=22, N=16), "multiple of 4"),
    (tpr._PC_PLAIN, dict(K=24, N=12), "of 8"),
    (tpr._PC_CONCAT, dict(K=24, N=16, K1=6), "concat split"),
], ids=["taps_c6", "taps_k", "k22", "n12", "k1_6"])
def test_tf32_gemm_rejects_shapes(mode, kw, match):
    C = kw.get("C", 8)
    X = torch.zeros((1, 8, C if mode == tpr._PC_TAPS3 else kw.get("K1") or kw["K"]))
    X2 = torch.zeros((1, 8, 18)) if mode == tpr._PC_CONCAT else None
    with pytest.raises(ValueError, match=match):
        tpr._tf32_gemm(mode, X, torch.zeros((kw["K"], kw["N"])), torch.zeros((kw["N"],)),
                       counter="bottleneck_chain", X2=X2, W=4, **kw)


@pytest.mark.parametrize("mode", [tpr._PC_PLAIN, tpr._PC_TAPS3, tpr._PC_CONCAT],
                         ids=["plain", "taps3", "concat"])
def test_tf32_gemm_cpu_route_is_the_plain_launch(mode):
    K = 72 if mode == tpr._PC_TAPS3 else 24
    X, X2, Wop, bias = _pc(mode, K=K)
    R = torch.randn((2, 12, 16)) if mode == tpr._PC_PLAIN else None
    kw = dict(K=K, N=16, W=4, C=8, X2=X2, R=R, K1=8 if mode == tpr._PC_CONCAT else 0)
    before = dict(_build.LAUNCHES)
    got = tpr._tf32_gemm(mode, X, Wop, bias, counter="bottleneck_chain", **kw)
    assert _build.LAUNCHES == before and got.dtype == torch.float32
    torch.testing.assert_close(got, tpr._wg_gemm_plain(mode, X, Wop, bias, kmajor=False, **kw),
                               rtol=0, atol=0)


def test_f32_chain_refuses_k3_layouts():
    """The f32 route takes K3's layouts since K3 runs on it: (C_out, K)
    weights with ``kmajor`` and the (C, P) output with ``out_cp``.  It still
    refuses weights whose orientation is not the one ``kmajor`` names."""
    x, flat, meta = _chain(torch.float32)  # (1, 64, 2048): layer4's (P, C) map
    with pytest.raises(ValueError, match=r"\(N, K\)"):  # K4's weights read as K3's
        tpr._tc_chain(x, flat, meta=meta, W=8, kmajor=True, counter="bottleneck_chain")
    got = tpr._tc_chain(x, flat, meta=meta, W=8, kmajor=False, counter="bottleneck_chain")
    torch.testing.assert_close(got, tpr.bottleneck_chain_plain(x, flat, meta=meta, H=8, W=8),
                               rtol=1e-6, atol=1e-6)
    from sequoia_tpu_torch.models import resnet

    params = resnet.random_params(torch.Generator().manual_seed(0))
    cflat, cmeta = tpr.stage_chain_weights_cp(params["layer4"], 1, torch.float32)
    cp = tpr._tc_chain(x, cflat, meta=cmeta, W=8, kmajor=True, out_cp=True,
                       counter="bottleneck_chain_cp")
    want = tpr.bottleneck_chain_cp_plain(x.transpose(1, 2).contiguous(), cflat, meta=cmeta,
                                         H=8, W=8)
    assert cp.shape == want.shape == (1, 2048, 64)
    torch.testing.assert_close(cp, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def test_vis_f32_route_checks_and_calls_the_tf32_entry(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    cfg = tvis.ViSConfig(num_outputs=8, input_dim=512, depth=1, nheads=4, dim_f=64,
                         dim_s=64, dim_c=64, num_clusters=10)
    chunks, smalls, pos = tpv.pack_vis_blocks(cfg, tvis.init(cfg, torch.Generator()
                                                                 .manual_seed(0)),
                                              torch.float32)
    x = torch.randn((10, 512))
    shifted = torch.zeros(chunks.numel() + 1)[1:].view(chunks.shape)
    shifted.copy_(chunks)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpv._vis_blocks_cuda(x, pos, shifted, smalls, 1, 4)
    assert lib.calls == []
    tpv._vis_blocks_cuda(x, pos, chunks, smalls, 1, 4)
    [(name, args)] = lib.calls
    assert name == "sq_vis_blocks" and args[0] == 0 and args[5:9] == (10, 256, 1, 64)
    assert _build.LAUNCHES["vis_blocks_fused"] == tpv.launches_per_call(1, 64, torch.float32)


def test_every_c_entry_is_bound():
    """The f32 tensor-core entries are bound and every FMA kernel is gone."""
    assert "sq_pc_tf32" in _build._SIGNATURES and "sq_pc_gemm" not in _build._SIGNATURES
    assert "sq_stem_tf32" in _build._SIGNATURES and "sq_conv_gemm" not in _build._SIGNATURES
    assert not (_build.CSRC / "vis_blocks.cu").exists()
    assert not (_build.CSRC / "conv_gemm.cu").exists()
    text = (_build.CSRC / "conv_wgmma.cu").read_text()
    assert 'extern "C" int sq_pc_tf32(' in text
    assert 'extern "C" int sq_stem_tf32(' in (_build.CSRC / "stem_wgmma.cu").read_text()
    assert 'extern "C" int sq_vis_blocks(' in (_build.CSRC / "vis_wgmma.cu").read_text()


# ---------------------------------------------------------------------------
# the offline CLIs' K4 stage line
# ---------------------------------------------------------------------------

def test_kernels_line_names_k4_stages():
    assert tcf.K4_STAGES == (1, 2, 3, 4)
    assert tcf.kernels_line([]) == "none (plain PyTorch)"
    assert tcf.kernels_line(["bottleneck_chain"]) == "bottleneck_chain (stages 1, 2, 3, 4)"
    assert tcf.kernels_line(["lloyd_stats"]) == "lloyd_stats"
