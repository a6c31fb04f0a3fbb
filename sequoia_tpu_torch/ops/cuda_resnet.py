"""ResNet kernels: K2 ``stem16`` and K3 ``bottleneck_chain_cp`` in the (C, P)
layout, K4 ``bottleneck_chain`` in the (P, C) layout.

Counterpart of ``sequoia_tpu/ops/pallas_resnet.py``: ``fold_block_weights``
(``:44-72``), ``chain_meta`` (``:75-81``), ``bottleneck_chain`` (``:151-190``)
and ``stage_chain_weights`` (``:193-198``), then the (C, P) half
(``:201-421``).  Same layouts as the JAX functions: ``stem16`` takes the
row-padded space-to-depth input ``(B, 16, (H2+3)*W2)`` and returns
``(B, 64, H2*W2)``; ``bottleneck_chain_cp`` takes and returns
``(B, C, H*W)``; ``bottleneck_chain`` takes and returns ``(B, H*W, C)``
(NHWC flattened).  The weight folding functions take the port's OIHW conv
weights.

On CUDA tensors all three run CUDA kernels on the tensor cores
(``wgmma``), in both types (each source says what bounds it on the H100 and
what its design does about it): bf16 operands, or in f32 3xTF32 products
(each operand split into TF32 hi and lo in the kernel, hi.hi + hi.lo +
lo.hi into an f32 accumulator).  K4 runs the (P, C) GEMMs of
``csrc/conv_wgmma.cu``; K3 runs K4's kernel after a transpose in (its
(C_out, K) weights read as a K-major B, its last launch writing the (C, P)
layout); K2 runs the stem of ``csrc/stem_wgmma.cu``.  On CPU tensors they
run the plain PyTorch versions beside them.  All round to the compute type
where the Pallas kernels do: after each ReLU of y1, y2 and the block
output.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from sequoia_tpu_torch import _build

# tap order of the 3x3 stack rows: (dy, dx) lexicographic, as the OIHW kernel
# permuted to (O, kh, kw, I) and flattened
TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

# operand modes of conv_wgmma.cu's (P, C) kernels
_PC_PLAIN, _PC_TAPS3, _PC_CONCAT = 4, 5, 6


def _mm(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(M, K) . (B, K, P) -> (B, M, P) from compute-type operands, in f32 for
    f32 and bf16 and in f64 for f64 (the reference the 3xTF32 kernels are
    held against)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return torch.matmul(w.to(acc), x.to(acc))


def _shifted(y: torch.Tensor, W: int, dy: int, dx: int, dim: int = -1) -> torch.Tensor:
    """y[q + dy*W + dx] at pixel q along the pixel axis ``dim`` of a (B, C, P)
    (``dim=-1``) or (B, P, C) (``dim=-2``) map, zero where the source leaves
    the image."""
    P = y.shape[dim]
    d = dy * W + dx
    q = torch.arange(P, device=y.device)
    col = q % W + dx
    src = q + d
    ok = (col >= 0) & (col < W) & (src >= 0) & (src < P)
    if dim == -2:
        ok = ok[:, None]
    rolled = torch.roll(y, shifts=-d, dims=dim) if d else y
    return torch.where(ok, rolled, torch.zeros((), dtype=y.dtype, device=y.device))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def fold_stem16_weights(w_s2d: torch.Tensor, bn1: dict, dtype) -> tuple:
    """(64, 12, 4, 4) OIHW space-to-depth stem + folded BN -> (A (64, 256),
    b (64, 1) f32).  A's 16 column groups of 16 are the (ky, kx) taps; in a
    group the first 12 columns are the scaled (di, dj, c) weights and the
    last 4 are zero, matching the 16-channel padded input."""
    a = w_s2d.float() * bn1["scale"].float()[:, None, None, None]
    a = F.pad(a.permute(0, 2, 3, 1), (0, 4))  # (64, ky, kx, 16)
    return (a.reshape(64, 256).to(dtype).contiguous(),
            bn1["bias"].float().reshape(64, 1).contiguous())


def fold_block_weights(blk: dict, dtype) -> tuple:
    """One bottleneck block (OIHW convs + folded-BN dicts) -> (w1, b1, w2s,
    b2, w3, b3) in (K, C_out) orientation, biases (1, C_out) f32.  w2s rows
    are (dy, dx, cin) as in the JAX HWIO reshape; a projection block's w3 is
    [W3; Wd] stacked on K with b3 + bd."""
    def fold(w, bnp):  # w (K, C_out): scale the output channels in f32
        return ((w.float() * bnp["scale"].float()[None, :]).to(dtype).contiguous(),
                bnp["bias"].float().reshape(1, -1).contiguous())

    width = blk["conv1"].shape[0]
    w1, b1 = fold(blk["conv1"][:, :, 0, 0].t(), blk["bn1"])
    w2s, b2 = fold(blk["conv2"].permute(2, 3, 1, 0).reshape(9 * width, width), blk["bn2"])
    w3, b3 = fold(blk["conv3"][:, :, 0, 0].t(), blk["bn3"])
    if "downsample_conv" in blk:
        wd, bd = fold(blk["downsample_conv"][:, :, 0, 0].t(), blk["downsample_bn"])
        return (w1, b1, w2s, b2, torch.cat([w3, wd], dim=0).contiguous(), b3 + bd)
    return (w1, b1, w2s, b2, w3, b3)


def fold_block_weights_cp(blk: dict, dtype) -> tuple:
    """One bottleneck block (OIHW convs + folded-BN dicts) -> (w1, b1, w2, b2,
    w3, b3) in (C_out, K) orientation; w2's columns are (tap, cin) and a
    projection block's w3 is [W3 | Wd] with b3 + bd."""
    def fold(w, bnp):  # w (C_out, K): scale the output channels in f32
        s = bnp["scale"].float()[:, None]
        return ((w.float() * s).to(dtype).contiguous(),
                bnp["bias"].float().reshape(-1, 1).contiguous())

    width = blk["conv1"].shape[0]
    w1, b1 = fold(blk["conv1"][:, :, 0, 0], blk["bn1"])
    w2, b2 = fold(blk["conv2"].permute(0, 2, 3, 1).reshape(width, 9 * width), blk["bn2"])
    w3, b3 = fold(blk["conv3"][:, :, 0, 0], blk["bn3"])
    if "downsample_conv" in blk:
        wd, bd = fold(blk["downsample_conv"][:, :, 0, 0], blk["downsample_bn"])
        return (w1, b1, w2, b2, torch.cat([w3, wd], dim=1).contiguous(), b3 + bd)
    return (w1, b1, w2, b2, w3, b3)


def chain_meta(blocks: list[dict]) -> tuple:
    """Per-block (cin, width, cout, has_projection)."""
    return tuple((int(b["conv1"].shape[1]), int(b["conv1"].shape[0]),
                  int(b["conv3"].shape[0]), "downsample_conv" in b) for b in blocks)


def stage_chain_weights(blocks: list[dict], start: int, dtype):
    """Fold blocks[start:] of a stage into (flat_weights, meta) for
    :func:`bottleneck_chain`."""
    flat: list = []
    for blk in blocks[start:]:
        flat.extend(fold_block_weights(blk, dtype))
    return tuple(flat), chain_meta(blocks[start:])


def stage_chain_weights_cp(blocks: list[dict], start: int, dtype):
    """Fold blocks[start:] of a stage into (flat_weights, meta)."""
    flat: list = []
    for blk in blocks[start:]:
        flat.extend(fold_block_weights_cp(blk, dtype))
    return tuple(flat), chain_meta(blocks[start:])


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _check(name, x, *others):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: activations must be f32 or bf16, got {x.dtype}")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"{name}: operands on different devices")


def stem16_plain(x16, a, b, *, H2: int, W2: int) -> torch.Tensor:
    """Plain PyTorch stem16: the 16-tap stack built with rolls and masks,
    then one (64, 256) GEMM + bias + ReLU, accumulated as :func:`_mm` does
    (an f64 ``x16`` with f64 weights runs in f64)."""
    P = H2 * W2
    taps = []
    for ky in range(4):
        base = x16[:, :, ky * W2:ky * W2 + P]
        for dx in (-2, -1, 0, 1):
            taps.append(_shifted(base, W2, 0, dx))
    y = _mm(a, torch.cat(taps, dim=1)) + b
    return torch.relu(y).to(x16.dtype)


# pixels per tile of the tensor-core stem (csrc/stem_wgmma.cu)
STEM_TILE = 128


def stem16_tiles_plain(x16, a, b, *, H2: int, W2: int) -> torch.Tensor:
    """Plain PyTorch version of the tensor-core stem's tile walk
    (``csrc/stem_wgmma.cu``): the pixels in tiles of :data:`STEM_TILE`, the
    ragged last one zero-padded; each (ky, channel, 8-pixel chunk) item read
    as the chunk, the two values before it and the one after it, those
    neighbours zero where they leave the image row; row kx of the tap stack
    is values kx..kx+7 of those 11; then per tile the (64, 256) . (256, 128)
    product, bias, ReLU and one rounding.  Needs W2 % 8 == 0, as the kernel."""
    if W2 % 8:
        raise ValueError(f"stem16: the tensor-core stem needs W2 % 8 == 0, got W2={W2}")
    B, P = x16.shape[0], H2 * W2
    tiles = -(-P // STEM_TILE)
    q0 = torch.arange(tiles * STEM_TILE // 8, device=x16.device)[:, None] * 8
    e = torch.arange(11, device=x16.device)[None, :]
    c0 = q0 % W2
    ok = (q0 < P) & ((e >= 2) & (e < 10) | (e < 2) & (c0 > 0) | (e == 10) & (c0 + 8 < W2))
    src = (q0 + e - 2).clamp(0, P - 1)
    rows = []
    for ky in range(4):
        base = x16[:, :, ky * W2:ky * W2 + P]
        window = torch.where(ok, base[:, :, src], torch.zeros((), dtype=x16.dtype,
                                                              device=x16.device))
        rows += [window[..., kx:kx + 8].reshape(B, 16, -1) for kx in range(4)]
    stack = torch.cat(rows, dim=1).reshape(B, 256, tiles, STEM_TILE)  # row (ky*4+kx)*16 + c
    y = torch.einsum("mk,bktp->bmtp", a.float(), stack.float()).reshape(B, 64, -1)[..., :P]
    return torch.relu(y + b.float().reshape(64, 1)).to(x16.dtype)


def _stem_wgmma_check(x16, a, b, *, W2: int, dtype=torch.bfloat16) -> None:
    """Raise on what the tensor-core stems do not take: operands of
    ``dtype`` (bf16 for ``sq_stem_wgmma``, f32 for the 3xTF32
    ``sq_stem_tf32``), contiguous and 16-byte aligned, whole 16-byte bf16
    chunks of a pixel row (W2 % 8 == 0, kept by the f32 stem too)."""
    route = "tensor-core route takes bf16" if dtype == torch.bfloat16 else \
        "3xTF32 route takes f32"
    for t in (x16, a):
        if t.dtype != dtype:
            raise TypeError(f"stem16: the {route}, got {t.dtype}")
    for t in (x16, a, b):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("stem16: the tensor-core route needs contiguous, 16-byte "
                             "aligned operands")
    if W2 % 8:
        raise ValueError(f"stem16: the tensor-core stem needs W2 % 8 == 0, got W2={W2}")
    if b.dtype != torch.float32 or b.numel() != 64:
        raise ValueError("stem16: bias must be 64 f32 values")


def _stem16_cuda(x16, a, b, *, H2: int, W2: int) -> torch.Tensor:
    """One kernel launch on the tensor cores: bf16 ``sq_stem_wgmma``, f32
    the 3xTF32 ``sq_stem_tf32``."""
    dt = x16.dtype
    a, b = a.to(dt).contiguous(), b.float().contiguous()
    _stem_wgmma_check(x16, a, b, W2=W2, dtype=dt)
    out = torch.empty((x16.shape[0], 64, H2 * W2), dtype=dt, device=x16.device)
    lib = _build.library()
    entry = lib.sq_stem_tf32 if dt == torch.float32 else lib.sq_stem_wgmma
    rc = entry(x16.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), x16.shape[0],
               H2, W2, _build.stream_ptr(x16))
    _build.check(rc, "stem16")
    _build.count_launch("stem16")
    return out


def stem16(x16: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, H2: int,
           W2: int) -> torch.Tensor:
    """(B, 16, (H2+3)*W2) -> (B, 64, H2*W2) stem activations (conv + BN +
    ReLU).  The 16 channels are the 12 space-to-depth channels and 4 zero
    ones; the rows carry 2 zero rows on top and 1 below.  On the card bf16
    takes the bf16 tensor-core kernel and f32 the 3xTF32 one (W2 % 8 == 0,
    x16 contiguous and 16-byte aligned, or it raises)."""
    B, c16, P_in = x16.shape
    if c16 != 16 or P_in != (H2 + 3) * W2 or a.shape != (64, 256):
        raise ValueError(f"stem16: bad shapes x16 {tuple(x16.shape)}, A {tuple(a.shape)}")
    _check("stem16", x16, a, b)
    if not x16.is_cuda:
        return stem16_plain(x16, a, b, H2=H2, W2=W2)
    return _stem16_cuda(x16, a, b, H2=H2, W2=W2)


def bottleneck_chain_cp_plain(x, flat_weights, *, meta, H: int, W: int) -> torch.Tensor:
    """Plain PyTorch chain: per block 1x1, the 9-tap stack GEMM, then the
    (merged projection or residual) 1x1, each followed by ReLU.  f32 and
    bf16 accumulate in f32; an f64 ``x`` (with f64 weights) runs the whole
    chain in f64, the reference the 3xTF32 kernel is held against."""
    cd = x.dtype
    for i, (_, _, _, has_ds) in enumerate(meta):
        w1, b1, w2, b2, w3, b3 = flat_weights[6 * i:6 * i + 6]
        y1 = torch.relu(_mm(w1, x) + b1).to(cd)
        stack = torch.cat([_shifted(y1, W, dy, dx) for dy, dx in TAPS], dim=1)
        y2 = torch.relu(_mm(w2, stack) + b2).to(cd)
        if has_ds:
            y3 = _mm(w3, torch.cat([y2, x], dim=1)) + b3
        else:
            y3 = _mm(w3, y2) + b3
            y3 = y3 + x.to(y3.dtype)
        x = torch.relu(y3).to(cd)
    return x


def bottleneck_chain_cp(x: torch.Tensor, flat_weights: tuple, *, meta: tuple,
                        H: int, W: int) -> torch.Tensor:
    """(B, Cin, H*W) -> (B, Cout, H*W) through stride-1 bottleneck blocks
    (weights from :func:`stage_chain_weights_cp`).  On the card both types
    run K4's tensor-core GEMMs (bf16, or f32 as 3xTF32) after one transpose
    of ``x`` to (B, H*W, Cin): the (C_out, K) weights are read as a K-major
    B, and the last launch writes the (C, P) layout."""
    _, cin, P = x.shape
    if P != H * W or cin != meta[0][0]:
        raise ValueError(f"bottleneck_chain_cp: x {tuple(x.shape)} vs H={H}, W={W}, "
                         f"cin={meta[0][0]}")
    _check("bottleneck_chain_cp", x, *flat_weights)
    if not x.is_cuda:
        return bottleneck_chain_cp_plain(x, flat_weights, meta=meta, H=H, W=W)
    return _tc_chain(x.transpose(1, 2).contiguous(), flat_weights, meta=meta, W=W,
                     kmajor=True, out_cp=True, counter="bottleneck_chain_cp")


def bottleneck_chain_plain(x, flat_weights, *, meta, H: int, W: int) -> torch.Tensor:
    """Plain PyTorch (P, C) chain: per block the 1x1 GEMM, the (P, 9*width)
    tap stack GEMM, then the (merged projection or residual) 1x1, each
    followed by ReLU.  f32 and bf16 accumulate in f32; an f64 ``x`` (with
    f64 weights) runs the whole chain in f64, the reference the 3xTF32
    kernel is held against."""
    cd = x.dtype
    acc = torch.promote_types(cd, torch.float32)
    for i, (_, _, _, has_ds) in enumerate(meta):
        w1, b1, w2s, b2, w3, b3 = flat_weights[6 * i:6 * i + 6]
        y1 = torch.relu(torch.matmul(x.to(acc), w1.to(acc)) + b1).to(cd)
        stack = torch.cat([_shifted(y1, W, dy, dx, dim=-2) for dy, dx in TAPS], dim=-1)
        y2 = torch.relu(torch.matmul(stack.to(acc), w2s.to(acc)) + b2).to(cd)
        if has_ds:
            y3 = torch.matmul(torch.cat([y2, x], dim=-1).to(acc), w3.to(acc)) + b3
        else:
            y3 = torch.matmul(y2.to(acc), w3.to(acc)) + b3 + x.to(acc)
        x = torch.relu(y3).to(cd)
    return x


def bottleneck_chain(x: torch.Tensor, flat_weights: tuple, *, meta: tuple, H: int,
                     W: int, row_chunk: int = 512) -> torch.Tensor:
    """(B, H*W, Cin) -> (B, H*W, Cout) through stride-1 bottleneck blocks
    (weights from :func:`stage_chain_weights`).

    ``row_chunk`` keeps the JAX checks (whole image rows, dividing H*W); the
    Pallas kernel chunks rows only to bound its VMEM, and the result does not
    depend on it, so the CUDA kernel tiles the pixels its own way.  On the
    card bf16 runs the bf16 tensor-core kernel and f32 the 3xTF32 one (or
    either raises on what it does not take)."""
    _, P, cin = x.shape
    if P != H * W:
        raise ValueError(f"bottleneck_chain: P={P} != H*W={H}*{W}")
    R = min(row_chunk, P)
    if P % R or R % W:
        raise ValueError(f"bottleneck_chain: row_chunk {R} must divide P={P} in whole "
                         f"rows of W={W}")
    widths = {m[1] for m in meta}
    if len(widths) != 1:
        raise ValueError(f"bottleneck_chain: the chain needs a uniform width, got {widths}")
    if cin != meta[0][0]:
        raise ValueError(f"bottleneck_chain: x has {cin} channels, the chain takes "
                         f"{meta[0][0]}")
    _check("bottleneck_chain", x, *flat_weights)
    if not x.is_cuda:
        return bottleneck_chain_plain(x, flat_weights, meta=meta, H=H, W=W)
    return _tc_chain(x.contiguous(), flat_weights, meta=meta, W=W, kmajor=False,
                     counter="bottleneck_chain")


# ---------------------------------------------------------------------------
# the tensor-core routes (csrc/conv_wgmma.cu), shared by K3 and K4: bf16 and
# 3xTF32 f32
# ---------------------------------------------------------------------------

def _wg_check(mode, X, Wop, bias, *, K, N, C=0, K1=0, X2=None, R=None) -> None:
    """Raise on what the tensor-core kernel does not take: it reads bf16 in
    16-byte chunks of 8 channels from contiguous, 16-byte aligned tensors."""
    ops = [t for t in (X, Wop, X2, R) if t is not None]
    for t in ops:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"pc_wgmma: the tensor-core route takes bf16, got {t.dtype}")
    for t in (*ops, bias):
        if t.device != X.device:
            raise ValueError("pc_wgmma: operands on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("pc_wgmma: operands must be contiguous and 16-byte aligned")
    if mode == _PC_TAPS3 and (C % 8 or K != 9 * C):
        raise ValueError(f"pc_wgmma: the 3x3 taps need C % 8 == 0 and K == 9*C, "
                         f"got C={C}, K={K}")
    if K % 8 or N % 8:
        raise ValueError(f"pc_wgmma: K={K} and N={N} must be multiples of 8")
    if mode == _PC_CONCAT and (K1 % 8 or not 0 < K1 < K):
        raise ValueError(f"pc_wgmma: the concat split K1={K1} must be a multiple of 8 "
                         f"inside K={K}")
    if bias.numel() != N or bias.dtype != torch.float32:
        raise ValueError(f"pc_wgmma: bias must be {N} f32 values")


def _wg_gemm_plain(mode, X, Wop, bias, *, K, N, kmajor, W=1, C=0, X2=None, R=None,
                   K1=0, out_cp=False) -> torch.Tensor:
    """Plain PyTorch version of one tensor-core launch (same operands)."""
    if mode == _PC_TAPS3:
        a = torch.cat([_shifted(X, W, dy, dx, dim=-2) for dy, dx in TAPS], dim=-1)
    elif mode == _PC_CONCAT:
        a = torch.cat([X, X2], dim=-1)
    else:
        a = X
    w = Wop.t() if kmajor else Wop
    y = torch.matmul(a.float(), w.float()) + bias.reshape(-1)
    if R is not None:
        y = y + R.float()
    y = torch.relu(y).to(X.dtype)
    return y.transpose(1, 2).contiguous() if out_cp else y


def _wg_gemm(mode, X, Wop, bias, *, K, N, kmajor, counter, W=1, C=0, X2=None, R=None,
             K1=0, out_cp=False) -> torch.Tensor:
    """One bf16 tensor-core GEMM per image: (B, P, N) = relu(Aop(X[b]) . B +
    bias [+ R[b]]), B = ``Wop`` stored (K, N), or (N, K) when ``kmajor``;
    ``out_cp`` returns it as (B, N, P)."""
    _wg_check(mode, X, Wop, bias, K=K, N=N, C=C, K1=K1, X2=X2, R=R)
    if not X.is_cuda:
        return _wg_gemm_plain(mode, X, Wop, bias, K=K, N=N, kmajor=kmajor, W=W, C=C,
                              X2=X2, R=R, K1=K1, out_cp=out_cp)
    B, P = X.shape[0], X.shape[1]
    out = torch.empty((B, N, P) if out_cp else (B, P, N), dtype=X.dtype, device=X.device)
    rc = _build.library().sq_pc_wgmma(
        mode, int(kmajor), X.data_ptr(), None if X2 is None else X2.data_ptr(),
        Wop.data_ptr(), bias.data_ptr(), None if R is None else R.data_ptr(),
        out.data_ptr(), B * P, P, K, K1, N, W, C, int(out_cp), _build.stream_ptr(X))
    _build.check(rc, "pc_wgmma")
    _build.count_launch(counter)
    return out


def _tf32_check(mode, X, Wop, bias, *, K, N, kmajor=False, C=0, K1=0, X2=None,
                R=None) -> None:
    """Raise on what the 3xTF32 kernel does not take: f32 in 16-byte chunks
    of 4 channels (the epilogue's rows in 8) from contiguous, 16-byte
    aligned tensors, the weights stored (K, N), or (N, K) when ``kmajor``."""
    ops = [t for t in (X, Wop, X2, R) if t is not None]
    for t in ops:
        if t.dtype != torch.float32:
            raise TypeError(f"pc_tf32: the 3xTF32 route takes f32, got {t.dtype}")
    for t in (*ops, bias):
        if t.device != X.device:
            raise ValueError("pc_tf32: operands on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("pc_tf32: operands must be contiguous and 16-byte aligned")
    if mode == _PC_TAPS3 and (C % 4 or K != 9 * C):
        raise ValueError(f"pc_tf32: the 3x3 taps need C % 4 == 0 and K == 9*C, "
                         f"got C={C}, K={K}")
    if K % 4 or N % 8:
        raise ValueError(f"pc_tf32: K={K} must be a multiple of 4 and N={N} of 8")
    if mode == _PC_CONCAT and (K1 % 4 or not 0 < K1 < K):
        raise ValueError(f"pc_tf32: the concat split K1={K1} must be a multiple of 4 "
                         f"inside K={K}")
    want = (N, K) if kmajor else (K, N)
    if Wop.shape != want:
        raise ValueError(f"pc_tf32: weights must be stored {'(N, K)' if kmajor else '(K, N)'}"
                         f" = {want}, got {tuple(Wop.shape)}")
    if bias.numel() != N or bias.dtype != torch.float32:
        raise ValueError(f"pc_tf32: bias must be {N} f32 values")


def _tf32_gemm(mode, X, Wop, bias, *, K, N, counter, kmajor=False, W=1, C=0, X2=None,
               R=None, K1=0, out_cp=False) -> torch.Tensor:
    """One f32 GEMM per image on the tensor cores as 3xTF32: (B, P, N) =
    relu(Aop(X[b]) . B + bias [+ R[b]]), B = ``Wop`` stored (K, N), or (N, K)
    when ``kmajor``; ``out_cp`` returns it as (B, N, P)."""
    _tf32_check(mode, X, Wop, bias, K=K, N=N, kmajor=kmajor, C=C, K1=K1, X2=X2, R=R)
    if not X.is_cuda:
        return _wg_gemm_plain(mode, X, Wop, bias, K=K, N=N, kmajor=kmajor, W=W, C=C,
                              X2=X2, R=R, K1=K1, out_cp=out_cp)
    B, P = X.shape[0], X.shape[1]
    out = torch.empty((B, N, P) if out_cp else (B, P, N), dtype=X.dtype, device=X.device)
    rc = _build.library().sq_pc_tf32(
        mode, int(kmajor), X.data_ptr(), None if X2 is None else X2.data_ptr(),
        Wop.data_ptr(), bias.data_ptr(), None if R is None else R.data_ptr(),
        out.data_ptr(), B * P, P, K, K1, N, W, C, int(out_cp), _build.stream_ptr(X))
    _build.check(rc, "pc_tf32")
    _build.count_launch(counter)
    return out


def _tc_chain(x, flat_weights, *, meta, W: int, kmajor: bool, counter: str,
              out_cp: bool = False):
    """The chain in the (P, C) layout, three tensor-core launches per block:
    (B, H*W, Cin) -> (B, H*W, Cout), or (B, Cout, H*W) with ``out_cp`` (the
    last launch writes K3's layout).  bf16 ``x`` runs the bf16 kernel, f32
    ``x`` the 3xTF32 one; ``kmajor`` says the weights are K3's (C_out, K)
    orientation instead of K4's (K, C_out), both read as they are."""
    cd = x.dtype
    gemm = functools.partial(_wg_gemm if cd == torch.bfloat16 else _tf32_gemm,
                             kmajor=kmajor, counter=counter)
    for i, (ci, width, cout, has_ds) in enumerate(meta):
        w1, b1, w2, b2, w3, b3 = (t.contiguous() for t in flat_weights[6 * i:6 * i + 6])
        w1, w2, w3 = w1.to(cd), w2.to(cd), w3.to(cd)
        b1, b2, b3 = b1.float(), b2.float(), b3.float()
        kw = {"out_cp": out_cp and i == len(meta) - 1}
        y1 = gemm(_PC_PLAIN, x, w1, b1, K=ci, N=width)
        y2 = gemm(_PC_TAPS3, y1, w2, b2, K=9 * width, N=width, W=W, C=width)
        if has_ds:
            x = gemm(_PC_CONCAT, y2, w3, b3, K=width + ci, K1=width, N=cout, X2=x, **kw)
        else:
            if ci != cout:
                raise ValueError("bottleneck_chain: identity block needs cin == cout")
            x = gemm(_PC_PLAIN, y2, w3, b3, K=width, N=cout, R=x, **kw)
    return x
