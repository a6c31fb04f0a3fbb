"""The bf16 tensor-core route of K1 (ops/cuda_vis.py, csrc/vis_wgmma.cu) on
the CPU: the wrapper's routing and checks against a stand-in for the kernel
library, and the plain version of the kernel's decomposition (swapped,
split-K GEMMs over token tiles of 104) against the JAX Pallas kernel in
interpret mode and against the port's plain block stack."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sequoia_tpu.models import vis as jvis
from sequoia_tpu.ops import pallas_vis as jpv
from sequoia_tpu_torch import _build
from sequoia_tpu_torch.models import convert as tconvert
from sequoia_tpu_torch.models import vis as tvis
from sequoia_tpu_torch.ops import cuda_vis as tpv


def _cfgs(depth, n):
    """P = 256 in 4 heads of 64, as tests/test_torch_vis.py."""
    base = dict(num_outputs=32, input_dim=512, depth=depth, nheads=4, dim_f=64, dim_s=64,
                dim_c=64, num_clusters=n)
    return jvis.ViSConfig(**base), tvis.ViSConfig(**base)


def _carry(jparams):
    return tconvert.vis_params_from_numpy(jax.tree.map(np.asarray, jparams))


class _FakeLib:
    """Stands in for the kernel library: records each C call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    return lib


def _packed(dtype, depth=2, n=10, nheads=4, p=256):
    cfg = tvis.ViSConfig(num_outputs=8, input_dim=2 * p, depth=depth, nheads=nheads,
                         dim_f=p // nheads, dim_s=p // nheads, dim_c=p // nheads,
                         num_clusters=n)
    params = tvis.init(cfg, torch.Generator().manual_seed(0))
    chunks, smalls, pos = tpv.pack_vis_blocks(cfg, params, dtype)
    return torch.randn((n, 2 * p), generator=torch.Generator().manual_seed(1)), pos, chunks, smalls


# ---------------------------------------------------------------------------
# the wrapper: which kernel, what it refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "sq_vis_wgmma"),
                                         (torch.float32, "sq_vis_blocks")],
                         ids=["bf16", "f32"])
def test_cuda_route_picks_the_kernel(fake_lib, dtype, entry):
    x, pos, chunks, smalls = _packed(dtype, depth=2)
    out = tpv._vis_blocks_cuda(x, pos, chunks, smalls, 2, 4)
    assert out.shape == x.shape and out.dtype == torch.float32
    [(name, args)] = fake_lib.calls
    assert name == entry
    # f32 keeps the FMA kernel's entry, which takes the dtype first (0 = f32)
    shift = 0 if entry == "sq_vis_wgmma" else 1
    if shift:
        assert args[0] == 0
    assert args[shift + 4:shift + 8] == (10, 256, 2, 64)  # M, P, depth, hw
    assert len(args) == len(_build._SIGNATURES[entry])
    assert _build.LAUNCHES["vis_blocks_fused"] == 1 + 8 * 2


def test_bf16_route_rejects_odd_head_width(fake_lib):
    """An odd head width (hw = 1) in bf16 reaches the tensor-core kernel: its
    per-head LN runs as a launch of its own (two features a lane would mix
    two heads in the GEMM's epilogue); f32 keeps it in the epilogue."""
    x, pos, chunks, smalls = _packed(torch.bfloat16, depth=1, nheads=128, p=128)  # hw = 1
    tpv._vis_blocks_cuda(x, pos, chunks, smalls, 1, 128)
    [(name, args)] = fake_lib.calls
    assert name == "sq_vis_wgmma" and args[4:8] == (10, 128, 1, 1)
    assert _build.LAUNCHES["vis_blocks_fused"] == 1 + 9 == tpv.launches_per_call(1, 1)
    assert tpv.launches_per_call(1, 1, torch.float32) == 1 + 8
    assert not tpv.ln_in_epilogue(1, "bfloat16") and tpv.ln_in_epilogue(2, "bfloat16")


def test_bf16_route_rejects_unaligned_chunks(fake_lib):
    x, pos, chunks, smalls = _packed(torch.bfloat16, depth=1)
    flat = torch.zeros(chunks.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(chunks.shape)  # 2-byte offset, still contiguous
    shifted.copy_(chunks)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpv._vis_blocks_cuda(x, pos, shifted, smalls, 1, 4)
    with pytest.raises(TypeError, match="bf16"):
        tpv._wgmma_check(x, pos, chunks.float(), smalls)
    assert fake_lib.calls == []


def test_cpu_tensors_run_the_plain_version(fake_lib):
    x, pos, chunks, smalls = _packed(torch.bfloat16, depth=1)
    out = tpv.vis_blocks_fused(x, pos, chunks, smalls, depth=1, nheads=4)
    assert fake_lib.calls == [] and _build.LAUNCHES["vis_blocks_fused"] == 0
    torch.testing.assert_close(out, tpv.vis_blocks_plain(x, pos, chunks, smalls, depth=1,
                                                         nheads=4), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the kernel's decomposition against JAX and the plain stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,n", [(1, 7), (2, 100), (1, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_plain_matches_jax_interpret(dtype, depth, n):
    jcfg, tcfg = _cfgs(depth, n)
    jp = jvis.init(jcfg, jax.random.PRNGKey(depth + n))
    x = np.random.default_rng(n).normal(size=(n, 512)).astype(np.float32)
    jchunks, jsmalls, jpos = jpv.pack_vis_blocks(jcfg, jp, dtype=getattr(jnp, dtype))
    want = np.asarray(jpv.vis_blocks_fused(jnp.asarray(x), jpos, jchunks, jsmalls, depth=depth,
                                           nheads=4, interpret=True))
    chunks, smalls, pos = tpv.pack_vis_blocks(tcfg, _carry(jp), getattr(torch, dtype))
    got = tpv.vis_blocks_split_plain(torch.as_tensor(x), pos, chunks, smalls, depth=depth,
                                     nheads=4).numpy()
    assert got.shape == (n, 512)
    if dtype == "float32":  # tests/test_torch_vis.py:129
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    else:  # tests/test_torch_vis.py:161-162: same rounding points, one ulp apart at most
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("n", [7, 130])
def test_split_plain_is_the_plain_stack_f32(n):
    """In f32 the split decomposition is the same function as the plain stack,
    up to f32 summation order."""
    x, pos, chunks, smalls = _packed(torch.float32, depth=2, n=n)
    got = tpv.vis_blocks_split_plain(x, pos, chunks, smalls, depth=2, nheads=4)
    want = tpv.vis_blocks_plain(x, pos, chunks, smalls, depth=2, nheads=4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_split_gemm_partition():
    """Every K slab goes to exactly one CTA of the cluster, also where the
    slabs do not divide evenly or are fewer than the CTAs (small integers, so
    every order of summation is exact)."""
    g = torch.Generator().manual_seed(3)
    for k, split in ((512, 8), (320, 4), (128, 4)):
        act = torch.randint(-3, 4, (9, k), generator=g).float()
        w = torch.randint(-3, 4, (k, 64), generator=g).float()
        torch.testing.assert_close(tpv._split_gemm(act, w, split), act @ w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# heads wider than one 64-feature tile (hw = 128), and widths K1 refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_heads_plain_versions_match_jax_interpret(dtype):
    """nheads = 2 of width 128 (P = 256), depth 2: the plain stack and the
    plain version of the kernel's decomposition (the per-head LN over two
    feature tiles, the combine over the head's 128 rows) against the Pallas
    kernel in interpret mode, at the tolerances of the 64-wide test."""
    base = dict(num_outputs=16, input_dim=512, depth=2, nheads=2, dim_f=128, dim_s=128,
                dim_c=128, num_clusters=100)
    jcfg, tcfg = jvis.ViSConfig(**base), tvis.ViSConfig(**base)
    jp = jvis.init(jcfg, jax.random.PRNGKey(7))
    x = np.random.default_rng(7).normal(size=(100, 512)).astype(np.float32)
    jchunks, jsmalls, jpos = jpv.pack_vis_blocks(jcfg, jp, dtype=getattr(jnp, dtype))
    want = np.asarray(jpv.vis_blocks_fused(jnp.asarray(x), jpos, jchunks, jsmalls, depth=2,
                                           nheads=2, interpret=True))
    chunks, smalls, pos = tpv.pack_vis_blocks(tcfg, _carry(jp), getattr(torch, dtype))
    for fn in (tpv.vis_blocks_plain, tpv.vis_blocks_split_plain):
        got = fn(torch.as_tensor(x), pos, chunks, smalls, depth=2, nheads=2).numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
        else:
            assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


def test_diag_gemm_takes_the_heads_rows():
    """The combine as the kernel forms it: features of a 64-wide tile meet
    the rows of their heads only, widened to whole 64-row slabs (the tile's
    own rows where hw | 64, the head's hw rows where 64 | hw, the straddled
    heads' rows otherwise); on a block-diagonal slab that is the full product
    (small integers, exact in any order)."""
    g = torch.Generator().manual_seed(4)
    for p, hw in ((256, 32), (256, 64), (256, 128), (512, 256), (768, 96), (384, 48),
                  (384, 3)):
        w = torch.zeros((p, p))
        for h in range(p // hw):
            sl = slice(h * hw, (h + 1) * hw)
            w[sl, sl] = torch.randint(-3, 4, (hw, hw), generator=g).float()
        act = torch.randint(-3, 4, (9, p), generator=g).float()
        torch.testing.assert_close(tpv._diag_gemm(act, w, hw), act @ w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "sq_vis_wgmma"),
                                         (torch.float32, "sq_vis_blocks")],
                         ids=["bf16", "f32"])
def test_cuda_route_takes_wide_heads(fake_lib, dtype, entry):
    """hw = 128 goes to the kernel with one more launch a block (the per-head
    LN on its own)."""
    x, pos, chunks, smalls = _packed(dtype, depth=2, nheads=2)
    tpv._vis_blocks_cuda(x, pos, chunks, smalls, 2, 2)
    [(name, args)] = fake_lib.calls
    shift = 0 if entry == "sq_vis_wgmma" else 1
    assert name == entry and args[shift + 4:shift + 8] == (10, 256, 2, 128)
    assert _build.LAUNCHES["vis_blocks_fused"] == 1 + 9 * 2 == tpv.launches_per_call(2, 128)


@pytest.mark.parametrize("heads,hw,in_epilogue", [
    (16, 64, True), (8, 128, False), (4, 256, False), (64, 16, True), (8, 96, False),
    (4, 192, False), (2, 2048, False), (128, 1, None)])
def test_kernel_takes(heads, hw, in_epilogue):
    """Both kernels take every config of JAX's gate, any head width; where
    the per-head LN runs (the f GEMM's epilogue, or a launch of its own)
    follows the width, and hw = 1 differs between the types."""
    cfg = tvis.ViSConfig(num_outputs=4, input_dim=2 * heads * hw, nheads=heads, dim_f=hw,
                         dim_s=hw, dim_c=hw)
    assert tpv.supported(cfg)
    assert tpv.kernel_takes(cfg, torch.float32) == tpv.kernel_takes(cfg, "bfloat16") == (
        True, "")
    f32, bf16 = tpv.ln_in_epilogue(hw, torch.float32), tpv.ln_in_epilogue(hw, "bfloat16")
    if in_epilogue is None:  # hw = 1: two features a bf16 lane would mix two heads
        assert f32 and not bf16
    else:
        assert f32 == bf16 == in_epilogue
    odd = tvis.ViSConfig(num_outputs=4, input_dim=200, nheads=4, dim_f=25, dim_s=25, dim_c=25)
    takes, why = tpv.kernel_takes(odd, torch.float32)  # P = 100: not the packed layout
    assert takes is False and "packed layout" in why and not tpv.supported(odd)


def test_cuda_route_refuses_a_width_it_does_not_take(fake_lib):
    """hw = 96 (heads straddle the 64-feature tiles) goes to the kernel with
    the per-head LN on its own; a head count that does not divide P (no
    whole head width) is refused before any launch."""
    x, pos, chunks, smalls = _packed(torch.float32, depth=1, nheads=4, p=384)  # hw = 96
    with pytest.raises(ValueError, match="head width"):
        tpv._vis_blocks_cuda(x, pos, chunks, smalls, 1, 5)
    assert fake_lib.calls == []
    tpv._vis_blocks_cuda(x, pos, chunks, smalls, 1, 4)
    [(name, args)] = fake_lib.calls
    assert name == "sq_vis_blocks" and args[5:9] == (10, 384, 1, 96)
    assert _build.LAUNCHES["vis_blocks_fused"] == 1 + 9


def test_predictor_refuses_at_construction_on_cuda_and_serves_on_cpu(monkeypatch):
    """hw = 96 fits JAX's gate (P = 768) and the kernel: a CUDA predictor
    with use_fused_vis packs the folds at construction (the tensors stay on
    the CPU here: the move to the card is stubbed), and a CPU predictor
    serves it through the plain version; a config outside the packed layout
    is refused on both devices before anything moves."""
    from sequoia_tpu_torch import serve as tserve
    from sequoia_tpu_torch.serve import SlidePredictor

    cfg = tvis.ViSConfig(num_outputs=6, input_dim=1536, depth=1, nheads=8, dim_f=96, dim_s=96,
                         dim_c=96, num_clusters=5)
    params = tvis.init(cfg, torch.Generator().manual_seed(0))
    assert tpv.supported(cfg)
    bad = tvis.ViSConfig(num_outputs=6, input_dim=1024, depth=1, nheads=16, num_clusters=5)
    for dev in ("cuda", "cpu"):
        with pytest.raises(ValueError, match="packed layout"):
            SlidePredictor(None, [(bad, tvis.init(bad, torch.Generator().manual_seed(0)))],
                           n_clusters=5, use_fused_vis=True, device=dev)
    with monkeypatch.context() as m:
        m.setattr(tserve, "tree_to", lambda tree, device: tree)
        on_cuda = SlidePredictor(None, [(cfg, params)], n_clusters=5, use_fused_vis=True,
                                 device="cuda")
    chunks, smalls, pos = on_cuda._packed[0]
    assert on_cuda.device.type == "cuda" and chunks.shape == (1, 16 * 768, 768)
    cpu = SlidePredictor(None, [(cfg, params)], n_clusters=5, use_fused_vis=True, device="cpu")
    plain = SlidePredictor(None, [(cfg, params)], n_clusters=5, device="cpu")
    cf = np.random.default_rng(0).normal(size=(5, 1536)).astype(np.float32)
    got = cpu.predict_cluster_features(cf)
    assert got.shape == (1, 6) and np.isfinite(got).all()
    np.testing.assert_allclose(got, plain.predict_cluster_features(cf), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_straddling_heads_plain_versions_match_jax_interpret(dtype):
    """nheads = 8 of width 96 (P = 768, input_dim 1536), depth 2, 100
    tokens: heads straddle the 64-feature tiles, so the per-head LN runs on
    its own and the combine takes the straddled heads' rows.  The plain
    stack and the plain version of the kernel's decomposition against the
    Pallas kernel in interpret mode, at the tolerances of the 64-wide test."""
    base = dict(num_outputs=16, input_dim=1536, depth=2, nheads=8, dim_f=96, dim_s=96,
                dim_c=96, num_clusters=100)
    jcfg, tcfg = jvis.ViSConfig(**base), tvis.ViSConfig(**base)
    assert jpv.supported(jcfg) and tpv.kernel_takes(tcfg, dtype) == (True, "")
    jp = jvis.init(jcfg, jax.random.PRNGKey(9))
    x = np.random.default_rng(9).normal(size=(100, 1536)).astype(np.float32)
    jchunks, jsmalls, jpos = jpv.pack_vis_blocks(jcfg, jp, dtype=getattr(jnp, dtype))
    want = np.asarray(jpv.vis_blocks_fused(jnp.asarray(x), jpos, jchunks, jsmalls, depth=2,
                                           nheads=8, interpret=True))
    chunks, smalls, pos = tpv.pack_vis_blocks(tcfg, _carry(jp), getattr(torch, dtype))
    for fn in (tpv.vis_blocks_plain, tpv.vis_blocks_split_plain):
        got = fn(torch.as_tensor(x), pos, chunks, smalls, depth=2, nheads=8).numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
        else:
            assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
