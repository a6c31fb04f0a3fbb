"""Fused ViS block stack for B = 1 serving: kernel K1 ``vis_blocks_fused``.

Counterpart of ``sequoia_tpu/ops/pallas_vis.py``.  :func:`pack_vis_blocks`
builds the same packed operands as the JAX function (per block a (16P, P)
chunk of row-stacked weight slabs and an (8, 3P) f32 "smalls" block; layout
in that module's docstring), :func:`vis_blocks_fused` runs the pos-emb add
and every block, and :func:`vis_apply_fused` adds the token mean, head
LayerNorm and (D, G) gene head outside the kernel, as ``vis.apply`` does.

On a CUDA tensor :func:`vis_blocks_fused` launches the tensor-core kernels
of ``csrc/vis_wgmma.cu`` (swapped, split-K GEMMs in thread-block clusters;
:func:`vis_blocks_split_plain` is their decomposition in plain PyTorch; the
source says what bounds them on the H100 and what the design does about
it): bf16 operands, or, in f32, 3xTF32 products (each operand split into
TF32 hi and lo in the kernel, hi.hi + hi.lo + lo.hi into an f32
accumulator).  On a CPU tensor it runs :func:`vis_blocks_plain`, the same
math in plain PyTorch.  The kernel rounds where the Pallas kernel rounds: the
residual stream is stored in the compute type between blocks and the last
block's output is f32.  GELU is exact erf (the Pallas kernel's
Abramowitz-Stegun polynomial was only a Mosaic workaround).
"""

from __future__ import annotations

import torch

from sequoia_tpu_torch import _build
from sequoia_tpu_torch.models import vis
from sequoia_tpu_torch.ops.nn import LN_EPS, compute_dtype, gelu

CHUNK_ROWS = 16  # x P
SMALL_ROWS = 8   # x 3P f32

# smalls row, column-segment (k = segment index, P wide) assignments
_SM = {"bf": (0, 0), "ln_f_scale": (0, 1), "ln_f_bias": (0, 2),
       "bs": (1, 0), "ln_s_scale": (1, 1), "ln_s_bias": (1, 2),
       "bc": (2, 0),
       "bp_lo": (3, 0), "bp_hi": (3, 1),
       "b1_lo": (4, 0), "b1_hi": (4, 1),
       "b2_lo": (5, 0), "b2_hi": (5, 1),
       "ln_ff_scale_lo": (6, 0), "ln_ff_scale_hi": (6, 1),
       "ln_ff_bias_lo": (7, 0), "ln_ff_bias_hi": (7, 1)}


def supported(cfg: vis.ViSConfig) -> bool:
    """True when this config maps onto the packed layout."""
    p = cfg.nheads * cfg.dim_f
    return (cfg.nheads * cfg.dim_s == p and cfg.nheads * cfg.dim_c == p
            and cfg.input_dim == 2 * p and p % 128 == 0)


def kernel_takes(cfg: vis.ViSConfig, dtype) -> tuple[bool, str]:
    """``(True, "")`` when the CUDA kernel of ``dtype`` (bf16 or 3xTF32 f32
    tensor-core GEMMs) takes this config, else ``(False, reason)``: both
    take every config of JAX's gate (``supported``), any head width."""
    compute_dtype(dtype)  # a dtype the kernels have
    if not supported(cfg):
        return False, ("ViS config does not fit the packed layout (nheads * dim_f = "
                       "nheads * dim_s = nheads * dim_c = input_dim / 2, a multiple of 128)")
    return True, ""


def ln_in_epilogue(hw: int, dtype) -> bool:
    """Whether the f GEMM runs the per-head LN in its epilogue
    (``ln_in_epilogue`` in ``csrc/vis_common.cuh``): a 64-feature tile holds
    whole heads, and in bf16 (two features a lane) hw is even.  Otherwise
    the GEMM stores f32 and ``vis_head_ln`` normalises whole heads."""
    return 64 % hw == 0 and (compute_dtype(dtype) == torch.float32 or hw % 2 == 0)


def launches_per_call(depth: int, hw: int, dtype=torch.bfloat16) -> int:
    """Kernel launches of one call: the pos-emb add, then eight per block,
    nine where the per-head LN runs as its own launch."""
    return 1 + (8 if ln_in_epilogue(hw, dtype) else 9) * depth


def pack_vis_blocks(cfg: vis.ViSConfig, params, dtype=torch.bfloat16):
    """Block parameters -> ``(chunks (depth, 16P, P) dtype, smalls
    (depth, 8, 3P) f32, pos_emb (N, D) dtype)``, on the params' device."""
    if not supported(cfg):
        raise ValueError("pack_vis_blocks: unsupported ViS shape")
    p, h, df, dc = cfg.nheads * cfg.dim_f, cfg.nheads, cfg.dim_f, cfg.dim_c
    b = {k: v.float() for k, v in params["blocks"].items()}
    dev = b["wf"].device
    chunks = torch.zeros((cfg.depth, CHUNK_ROWS * p, p), device=dev)
    smalls = torch.zeros((cfg.depth, SMALL_ROWS, 3 * p), device=dev)

    chunks[:, 0:2 * p] = b["wf"]
    chunks[:, 2 * p:4 * p] = b["ws"]
    for hh in range(h):  # block-diagonal combine
        r, c0 = hh * df, hh * dc
        chunks[:, 4 * p + r:4 * p + r + df, c0:c0 + dc] = b["wc"][:, hh, :df]
        chunks[:, 5 * p + r:5 * p + r + df, c0:c0 + dc] = b["wc"][:, hh, df:]
    for row0, name in ((6, "wproj"), (8, "w1"), (12, "w2")):
        n_in = b[name].shape[1] // p  # row slabs per column half
        chunks[:, row0 * p:(row0 + n_in) * p] = b[name][:, :, :p]
        chunks[:, (row0 + n_in) * p:(row0 + 2 * n_in) * p] = b[name][:, :, p:]

    def put(name, vec):
        r, k = _SM[name]
        smalls[:, r, k * p:(k + 1) * p] = vec.reshape(cfg.depth, p)

    for name, key in (("bf", "bf"), ("ln_f_scale", "ln_f_scale"),
                      ("ln_f_bias", "ln_f_bias"), ("bs", "bs"),
                      ("ln_s_scale", "ln_s_scale"), ("ln_s_bias", "ln_s_bias"),
                      ("bc", "bc")):
        put(name, b[key])
    for prefix, key in (("bp", "bproj"), ("b1", "b1"), ("b2", "b2"),
                        ("ln_ff_scale", "ln_ff_scale"), ("ln_ff_bias", "ln_ff_bias")):
        put(prefix + "_lo", b[key][:, :p])
        put(prefix + "_hi", b[key][:, p:])
    return chunks.to(dtype), smalls, params["pos_emb"].to(dtype)


def _group_ln(v: torch.Tensor, nheads: int, scale, bias) -> torch.Tensor:
    """Per-head LayerNorm of (rows, P) f32 over P // nheads wide groups."""
    rows, p = v.shape
    g = v.reshape(rows, nheads, p // nheads)
    mean = g.mean(-1, keepdim=True)
    var = (g - mean).square().mean(-1, keepdim=True)
    return ((g - mean) * torch.rsqrt(var + LN_EPS)).reshape(rows, p) * scale + bias


def vis_blocks_plain(x, pos, chunks, smalls, *, depth: int, nheads: int) -> torch.Tensor:
    """Plain PyTorch version of the fused block stack, the Pallas kernel's
    math step by step: ``(N, D)`` f32 -> ``(N, D)`` f32.  f64 operands run
    it in f64 (the reference the 3xTF32 kernel is held against)."""
    p = x.shape[1] // 2
    cd = chunks.dtype
    acc = torch.promote_types(cd, torch.float32)

    def dot(a, w):  # operands in the compute type, f32 (f64) accumulation
        return torch.matmul(a.to(cd).to(acc), w.to(acc))

    xs = (x + pos.to(acc)).to(cd)
    for i in range(depth):
        def row(name):
            r, k = _SM[name]
            return smalls[i, r, k * p:(k + 1) * p]

        def w(lo, n_rows=1):
            return chunks[i, lo * p:(lo + n_rows) * p]

        local = gelu(_group_ln(dot(xs, w(0, 2)) + row("bf"), nheads,
                               row("ln_f_scale"), row("ln_f_bias")))
        sv = (dot(xs, w(2, 2)) + row("bs")).mean(0, keepdim=True)
        summ = gelu(_group_ln(sv, nheads, row("ln_s_scale"), row("ln_s_bias")))
        c = gelu(dot(local, w(4)) + dot(summ, w(5)) + row("bc"))

        x32 = xs.to(acc)
        x_lo = x32[:, :p] + dot(c, w(6)) + row("bp_lo")
        x_hi = x32[:, p:] + dot(c, w(7)) + row("bp_hi")
        mean = (x_lo.sum(-1, keepdim=True) + x_hi.sum(-1, keepdim=True)) / (2 * p)
        var = ((x_lo - mean).square().sum(-1, keepdim=True)
               + (x_hi - mean).square().sum(-1, keepdim=True)) / (2 * p)
        rstd = torch.rsqrt(var + LN_EPS)
        y_lo = (x_lo - mean) * rstd * row("ln_ff_scale_lo") + row("ln_ff_bias_lo")
        y_hi = (x_hi - mean) * rstd * row("ln_ff_scale_hi") + row("ln_ff_bias_hi")
        h_lo = gelu(dot(y_lo, w(8)) + dot(y_hi, w(9)) + row("b1_lo"))
        h_hi = gelu(dot(y_lo, w(10)) + dot(y_hi, w(11)) + row("b1_hi"))
        x_lo = x_lo + dot(h_lo, w(12)) + dot(h_hi, w(13)) + row("b2_lo")
        x_hi = x_hi + dot(h_lo, w(14)) + dot(h_hi, w(15)) + row("b2_hi")
        out = torch.cat([x_lo, x_hi], dim=1)
        xs = out.to(cd)
    return out


# the tensor-core kernel's decomposition (csrc/vis_wgmma.cu): output
# features per CTA, tokens per CTA, K per slab, and the cluster sizes that
# split K of (f, s) and of (proj, ff1, ff2)
FEAT_TILE, TOKEN_TILE, SLAB = 64, 104, 64
SPLIT_F, SPLIT_FF = 8, 4


def _split_gemm(act, w, split: int) -> torch.Tensor:
    """(T, K) . (K, N) in f32 as the kernel forms it: per CTA of a cluster
    of ``split`` the product W^T . act^T over its share of the K slabs (CTA
    r takes slabs [r*nk/split, (r+1)*nk/split)), the f32 partials summed in
    rank order; returned (T, N)."""
    nk = act.shape[1] // SLAB
    a, wt = act.float(), w.float().t()
    total = torch.zeros((w.shape[1], act.shape[0]), device=act.device)
    for r in range(split):
        lo, hi = r * nk // split * SLAB, (r + 1) * nk // split * SLAB
        total = total + wt[:, lo:hi] @ a[:, lo:hi].t()
    return total.t()


def _diag_rows(n0: int, hw: int) -> slice:
    """The K rows that features [n0, n0 + 64) meet in the block-diagonal
    combine (``diag_first``/``diag_last`` in ``csrc/vis_common.cuh``): the
    rows of their heads, widened to whole 64-row slabs."""
    first = n0 // hw * hw // SLAB * SLAB
    return slice(first, -(-((n0 + FEAT_TILE - 1) // hw + 1) * hw // SLAB) * SLAB)


def _diag_gemm(act, w, hw: int) -> torch.Tensor:
    """The block-diagonal combine as the kernel forms it: features [n0, n0 +
    64) from the rows of :func:`_diag_rows` only (exact: the rows outside
    their heads are zero)."""
    out = torch.empty((act.shape[0], w.shape[1]), device=act.device)
    for n0 in range(0, w.shape[1], FEAT_TILE):
        sl, ks = slice(n0, n0 + FEAT_TILE), _diag_rows(n0, hw)
        out[:, sl] = (w[ks, sl].float().t() @ act[:, ks].float().t()).t()
    return out


def vis_blocks_split_plain(x, pos, chunks, smalls, *, depth: int,
                           nheads: int) -> torch.Tensor:
    """Plain PyTorch version of the tensor-core kernel's decomposition:
    tokens zero-padded to whole tiles of :data:`TOKEN_TILE`, every GEMM
    swapped and split over K as :func:`_split_gemm` (the combine block
    diagonal over each tile's heads, unsplit; the per-head LN over whole
    heads of the f32 sums, a launch of its own where a tile does not hold
    whole heads), the summary mean over the
    N real tokens, and the epilogues and rounding points of
    :func:`vis_blocks_plain`.  ``(N, D)`` f32 -> ``(N, D)`` f32."""
    n, p = x.shape[0], x.shape[1] // 2
    hw = p // nheads
    cd = chunks.dtype
    pad = -(-n // TOKEN_TILE) * TOKEN_TILE - n
    xs = torch.nn.functional.pad(x.float() + pos.float(), (0, 0, 0, pad)).to(cd)
    for i in range(depth):
        def row(*names):
            return torch.cat([smalls[i, r, k * p:(k + 1) * p]
                              for r, k in (_SM[nm] for nm in names)])

        def w(*slabs):  # output columns side by side: (K, len(slabs) * P)
            return torch.cat([chunks[i, lo * p:(lo + rows) * p] for lo, rows in slabs], dim=1)

        local = gelu(_group_ln(_split_gemm(xs, w((0, 2)), SPLIT_F) + row("bf"), nheads,
                               row("ln_f_scale"), row("ln_f_bias"))).to(cd)
        sv = (_split_gemm(xs, w((2, 2)), SPLIT_F) + row("bs"))[:n].mean(0, keepdim=True)
        summ = gelu(_group_ln(sv, nheads, row("ln_s_scale"), row("ln_s_bias"))).to(cd)
        sc = _diag_gemm(summ, w((5, 1)), hw)
        c = gelu(_diag_gemm(local, w((4, 1)), hw) + sc + row("bc")).to(cd)
        xf = xs.float() + _split_gemm(c, w((6, 1), (7, 1)), SPLIT_FF) + row("bp_lo", "bp_hi")
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + LN_EPS) * row("ln_ff_scale_lo", "ln_ff_scale_hi")
             + row("ln_ff_bias_lo", "ln_ff_bias_hi")).to(cd)
        h = gelu(_split_gemm(y, w((8, 2), (10, 2)), SPLIT_FF) + row("b1_lo", "b1_hi")).to(cd)
        out = xf + _split_gemm(h, w((12, 2), (14, 2)), SPLIT_FF) + row("b2_lo", "b2_hi")
        xs = out.to(cd)
    return out[:n]


def _aligned_check(x, pos, chunks, smalls) -> None:
    """Raise unless every operand is contiguous and 16-byte aligned, as the
    tensor-core kernels read them in 16-byte chunks."""
    for t in (x, pos, chunks, smalls):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("vis_blocks_fused: the tensor-core route needs contiguous, "
                             "16-byte aligned operands")


def _wgmma_check(x, pos, chunks, smalls) -> None:
    """Raise on what the bf16 tensor-core kernel does not take: bf16 chunks,
    contiguous 16-byte aligned operands."""
    if chunks.dtype != torch.bfloat16:
        raise TypeError(f"vis_blocks_fused: the tensor-core route takes bf16 chunks, "
                        f"got {chunks.dtype}")
    _aligned_check(x, pos, chunks, smalls)


def _vis_blocks_cuda(x, pos, chunks, smalls, depth: int, nheads: int) -> torch.Tensor:
    n, d = x.shape
    p = d // 2
    hw = p // nheads
    if chunks.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"vis_blocks_fused: chunks must be f32 or bf16, got {chunks.dtype}")
    if (d != 2 * p or chunks.shape != (depth, CHUNK_ROWS * p, p)
            or smalls.shape != (depth, SMALL_ROWS, 3 * p) or pos.shape != x.shape):
        raise ValueError("vis_blocks_fused: operand shapes do not match the packed layout")
    if p % 64 or p % nheads:
        raise ValueError(f"vis_blocks_fused kernel needs P % 64 == 0 and a whole head "
                         f"width, got P={p}, head width {p / nheads:g}")
    for t in (chunks, smalls, pos):
        if t.device != x.device:
            raise ValueError("vis_blocks_fused: operands on different devices")
    cd = chunks.dtype
    x = x.float().contiguous()
    pos = pos.float().contiguous()
    chunks = chunks.contiguous()
    smalls = smalls.float().contiguous()

    def buf(cols, dtype):
        return torch.empty((n, cols), dtype=dtype, device=x.device)

    xs, local, c, y, h = (buf(d, cd), buf(p, cd), buf(p, cd), buf(d, cd), buf(d, cd))
    s, xf, out = buf(p, torch.float32), buf(d, torch.float32), buf(d, torch.float32)
    sc = torch.empty((p,), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), pos.data_ptr(), chunks.data_ptr(), smalls.data_ptr(), n, p,
            depth, hw, xs.data_ptr(), local.data_ptr(), s.data_ptr(), sc.data_ptr(),
            c.data_ptr(), xf.data_ptr(), y.data_ptr(), h.data_ptr(), out.data_ptr(),
            _build.stream_ptr(x))
    lib = _build.library()
    if cd == torch.bfloat16:
        _wgmma_check(x, pos, chunks, smalls)
        rc = lib.sq_vis_wgmma(*args)
    else:
        _aligned_check(x, pos, chunks, smalls)
        rc = lib.sq_vis_blocks(0, *args)
    _build.check(rc, "vis_blocks_fused")
    _build.count_launch("vis_blocks_fused", launches_per_call(depth, hw, cd))
    return out


def vis_blocks_fused(x, pos_emb, chunks, smalls, *, depth: int, nheads: int) -> torch.Tensor:
    """``(N, D)`` f32 tokens -> ``(N, D)`` f32 output of the pos-emb add and
    all ``depth`` ViS blocks.  CUDA tensors run the kernel, CPU tensors the
    plain version; token mean and head stay with the caller."""
    if x.is_cuda:
        return _vis_blocks_cuda(x, pos_emb, chunks, smalls, depth, nheads)
    if x.device.type != "cpu":
        raise ValueError(f"vis_blocks_fused: unsupported device {x.device}")
    return vis_blocks_plain(x.float(), pos_emb, chunks, smalls, depth=depth, nheads=nheads)


def vis_apply_fused(cfg: vis.ViSConfig, params, packed, x: torch.Tensor) -> torch.Tensor:
    """Drop-in ``vis.apply`` for B = 1 serving: ``(1, N, D) -> (1, G)``, with
    ``packed`` from :func:`pack_vis_blocks`."""
    chunks, smalls, pos = packed
    if x.ndim != 3 or x.shape[0] != 1:
        raise ValueError(f"fused path serves B=1, got input shape {tuple(x.shape)}")
    if x.shape[1] != pos.shape[0] or x.shape[2] != cfg.input_dim:
        raise ValueError(f"input {tuple(x.shape)} does not match N={pos.shape[0]}, "
                         f"D={cfg.input_dim}")
    tokens = vis_blocks_fused(x[0].float(), pos, chunks, smalls,
                              depth=cfg.depth, nheads=cfg.nheads)
    return vis.head(params, tokens[None])
