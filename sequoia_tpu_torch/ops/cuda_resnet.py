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

On CUDA tensors all three run CUDA kernels (each source says what bounds
it on the H100 and what its design does about it).  K4 runs on the tensor
cores (``wgmma``) in both types, in the (P, C) layout of
``csrc/conv_wgmma.cu``: bf16 operands, or in f32 3xTF32 products (each
operand split into TF32 hi and lo in the kernel, hi.hi + hi.lo + lo.hi into
an f32 accumulator).  In bf16 K2 runs the tensor-core stem of
``csrc/stem_wgmma.cu`` and K3 K4's kernel after a transpose in (its last
launch writes the (C, P) layout); in f32 K2 and K3 run the CUDA-core
kernels of ``csrc/conv_gemm.cu``.  On CPU tensors they run the plain
PyTorch versions beside them.  All round to the compute type where the
Pallas kernels do: after each ReLU of y1, y2 and the block output.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from sequoia_tpu_torch import _build

# tap order of the 3x3 stack rows: (dy, dx) lexicographic, as the OIHW kernel
# permuted to (O, kh, kw, I) and flattened
TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

# operand modes: conv_gemm.cu's (C, P) kernels K2/K3, then conv_wgmma.cu's
# (P, C) kernels
_PLAIN, _TAPS3, _STEM, _CONCAT = 0, 1, 2, 3
_PC_PLAIN, _PC_TAPS3, _PC_CONCAT = 4, 5, 6


def _mm(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(M, K) . (B, K, P) -> (B, M, P) f32 from compute-type operands."""
    return torch.matmul(w.float(), x.float())


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

def _launch(mode, A, bias, X, out, *, M, K, N, W=1, X2=None, R=None, K1=0,
            xc, xs, x2s=0, rs=0, relu=True):
    lib = _build.library()
    rc = lib.sq_conv_gemm(
        1 if X.dtype == torch.bfloat16 else 0, mode, A.data_ptr(), bias.data_ptr(),
        X.data_ptr(), None if X2 is None else X2.data_ptr(),
        None if R is None else R.data_ptr(), out.data_ptr(), X.shape[0], M, K, K1, N,
        W, xc, xs, x2s, rs, out.shape[1] * out.shape[2], int(relu), _build.stream_ptr(X))
    _build.check(rc, "conv_gemm")


def _check(name, x, *others):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: activations must be f32 or bf16, got {x.dtype}")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"{name}: operands on different devices")


def stem16_plain(x16, a, b, *, H2: int, W2: int) -> torch.Tensor:
    """Plain PyTorch stem16: the 16-tap stack built with rolls and masks,
    then one (64, 256) GEMM + bias + ReLU."""
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


def _stem_wgmma_check(x16, a, b, *, W2: int) -> None:
    """Raise on what the tensor-core stem does not take: bf16 operands,
    contiguous and 16-byte aligned, whole 16-byte chunks of a pixel row."""
    for t in (x16, a):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"stem16: the tensor-core route takes bf16, got {t.dtype}")
    for t in (x16, a, b):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("stem16: the tensor-core route needs contiguous, 16-byte "
                             "aligned operands")
    if W2 % 8:
        raise ValueError(f"stem16: the tensor-core stem needs W2 % 8 == 0, got W2={W2}")
    if b.dtype != torch.float32 or b.numel() != 64:
        raise ValueError("stem16: bias must be 64 f32 values")


def _stem16_cuda(x16, a, b, *, H2: int, W2: int) -> torch.Tensor:
    """One kernel launch: bf16 the tensor-core stem (``sq_stem_wgmma``), f32
    the CUDA-core tap-gather GEMM (``sq_conv_gemm``)."""
    B, _, P_in = x16.shape
    P = H2 * W2
    lib = _build.library()
    if x16.dtype == torch.bfloat16:
        a, b = a.to(torch.bfloat16).contiguous(), b.float().contiguous()
        _stem_wgmma_check(x16, a, b, W2=W2)
        out = torch.empty((B, 64, P), dtype=x16.dtype, device=x16.device)
        rc = lib.sq_stem_wgmma(x16.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               B, H2, W2, _build.stream_ptr(x16))
        _build.check(rc, "stem16")
    else:
        x16 = x16.contiguous()
        out = torch.empty((B, 64, P), dtype=x16.dtype, device=x16.device)
        _launch(_STEM, a.to(x16.dtype).contiguous(), b.float().contiguous(), x16, out,
                M=64, K=256, N=P, W=W2, xc=P_in, xs=16 * P_in)
    _build.count_launch("stem16")
    return out


def stem16(x16: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, H2: int,
           W2: int) -> torch.Tensor:
    """(B, 16, (H2+3)*W2) -> (B, 64, H2*W2) stem activations (conv + BN +
    ReLU).  The 16 channels are the 12 space-to-depth channels and 4 zero
    ones; the rows carry 2 zero rows on top and 1 below.  On the card bf16
    takes the tensor-core kernel (W2 % 8 == 0, x16 contiguous and 16-byte
    aligned, or it raises), f32 the CUDA-core one."""
    B, c16, P_in = x16.shape
    if c16 != 16 or P_in != (H2 + 3) * W2 or a.shape != (64, 256):
        raise ValueError(f"stem16: bad shapes x16 {tuple(x16.shape)}, A {tuple(a.shape)}")
    _check("stem16", x16, a, b)
    if not x16.is_cuda:
        return stem16_plain(x16, a, b, H2=H2, W2=W2)
    return _stem16_cuda(x16, a, b, H2=H2, W2=W2)


def bottleneck_chain_cp_plain(x, flat_weights, *, meta, H: int, W: int) -> torch.Tensor:
    """Plain PyTorch chain: per block 1x1, the 9-tap stack GEMM, then the
    (merged projection or residual) 1x1, each followed by ReLU."""
    cd = x.dtype
    for i, (_, _, _, has_ds) in enumerate(meta):
        w1, b1, w2, b2, w3, b3 = flat_weights[6 * i:6 * i + 6]
        y1 = torch.relu(_mm(w1, x) + b1).to(cd)
        stack = torch.cat([_shifted(y1, W, dy, dx) for dy, dx in TAPS], dim=1)
        y2 = torch.relu(_mm(w2, stack) + b2).to(cd)
        if has_ds:
            y3 = _mm(w3, torch.cat([y2, x], dim=1)) + b3
        else:
            y3 = _mm(w3, y2) + b3 + x.float()
        x = torch.relu(y3).to(cd)
    return x


def bottleneck_chain_cp(x: torch.Tensor, flat_weights: tuple, *, meta: tuple,
                        H: int, W: int) -> torch.Tensor:
    """(B, Cin, H*W) -> (B, Cout, H*W) through stride-1 bottleneck blocks
    (weights from :func:`stage_chain_weights_cp`)."""
    B, cin, P = x.shape
    if P != H * W or cin != meta[0][0]:
        raise ValueError(f"bottleneck_chain_cp: x {tuple(x.shape)} vs H={H}, W={W}, "
                         f"cin={meta[0][0]}")
    _check("bottleneck_chain_cp", x, *flat_weights)
    if not x.is_cuda:
        return bottleneck_chain_cp_plain(x, flat_weights, meta=meta, H=H, W=W)
    if x.dtype == torch.bfloat16:  # the (C_out, K) weights are a K-major B
        return _tc_chain(x.transpose(1, 2).contiguous(), flat_weights, meta=meta, W=W,
                         kmajor=True, out_cp=True, counter="bottleneck_chain_cp")
    cd = x.dtype
    x = x.contiguous()
    for i, (ci, width, cout, has_ds) in enumerate(meta):
        w1, b1, w2, b2, w3, b3 = (t.contiguous() for t in flat_weights[6 * i:6 * i + 6])
        w1, w2, w3 = w1.to(cd), w2.to(cd), w3.to(cd)
        y1 = torch.empty((B, width, P), dtype=cd, device=x.device)
        _launch(_PLAIN, w1, b1, x, y1, M=width, K=ci, N=P, xc=P, xs=ci * P)
        y2 = torch.empty_like(y1)
        _launch(_TAPS3, w2, b2, y1, y2, M=width, K=9 * width, N=P, W=W, xc=P,
                xs=width * P)
        out = torch.empty((B, cout, P), dtype=cd, device=x.device)
        if has_ds:
            _launch(_CONCAT, w3, b3, y2, out, M=cout, K=width + ci, K1=width, N=P,
                    X2=x, xc=P, xs=width * P, x2s=ci * P)
        else:
            if ci != cout:
                raise ValueError("bottleneck_chain_cp: identity block needs cin == cout")
            _launch(_PLAIN, w3, b3, y2, out, M=cout, K=width, N=P, R=x, xc=P,
                    xs=width * P, rs=cout * P)
        _build.count_launch("bottleneck_chain_cp", 3)
        x = out
    return x


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
# the tensor-core routes (csrc/conv_wgmma.cu): bf16, shared by K3 and K4, and
# K4's 3xTF32 f32
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


def _tf32_check(mode, X, Wop, bias, *, K, N, C=0, K1=0, X2=None, R=None) -> None:
    """Raise on what the 3xTF32 kernel does not take: f32 in 16-byte chunks
    of 4 channels (the epilogue's rows in 8) from contiguous, 16-byte
    aligned tensors, the weights stored (K, N)."""
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
    if Wop.shape != (K, N):
        raise ValueError(f"pc_tf32: weights must be stored (K, N) = ({K}, {N}), got "
                         f"{tuple(Wop.shape)}")
    if bias.numel() != N or bias.dtype != torch.float32:
        raise ValueError(f"pc_tf32: bias must be {N} f32 values")


def _tf32_gemm(mode, X, Wop, bias, *, K, N, counter, W=1, C=0, X2=None, R=None,
               K1=0) -> torch.Tensor:
    """One f32 GEMM per image on the tensor cores as 3xTF32: (B, P, N) =
    relu(Aop(X[b]) . Wop + bias [+ R[b]]), Wop stored (K, N)."""
    _tf32_check(mode, X, Wop, bias, K=K, N=N, C=C, K1=K1, X2=X2, R=R)
    if not X.is_cuda:
        return _wg_gemm_plain(mode, X, Wop, bias, K=K, N=N, kmajor=False, W=W, C=C,
                              X2=X2, R=R, K1=K1)
    B, P = X.shape[0], X.shape[1]
    out = torch.empty((B, P, N), dtype=X.dtype, device=X.device)
    rc = _build.library().sq_pc_tf32(
        mode, X.data_ptr(), None if X2 is None else X2.data_ptr(), Wop.data_ptr(),
        bias.data_ptr(), None if R is None else R.data_ptr(), out.data_ptr(), B * P, P, K,
        K1, N, W, C, _build.stream_ptr(X))
    _build.check(rc, "pc_tf32")
    _build.count_launch(counter)
    return out


def _tc_chain(x, flat_weights, *, meta, W: int, kmajor: bool, counter: str,
              out_cp: bool = False):
    """The chain in the (P, C) layout, three tensor-core launches per block:
    (B, H*W, Cin) -> (B, H*W, Cout), or (B, Cout, H*W) with ``out_cp`` (the
    last launch writes K3's layout).  bf16 ``x`` runs the bf16 kernel, where
    ``kmajor`` says the weights are K3's (C_out, K) orientation instead of
    K4's (K, C_out), both read as they are; f32 ``x`` runs the 3xTF32 kernel
    on K4's (K, C_out) weights (no ``kmajor``, no ``out_cp``)."""
    cd = x.dtype
    if cd == torch.bfloat16:
        gemm = functools.partial(_wg_gemm, kmajor=kmajor, counter=counter)
    elif kmajor or out_cp:
        raise ValueError("bottleneck_chain: the f32 route takes K4's (K, C_out) weights "
                         "and writes the (P, C) layout")
    else:
        gemm = functools.partial(_tf32_gemm, counter=counter)
    for i, (ci, width, cout, has_ds) in enumerate(meta):
        w1, b1, w2, b2, w3, b3 = (t.contiguous() for t in flat_weights[6 * i:6 * i + 6])
        w1, w2, w3 = w1.to(cd), w2.to(cd), w3.to(cd)
        b1, b2, b3 = b1.float(), b2.float(), b3.float()
        kw = {"out_cp": out_cp and i == len(meta) - 1} if cd == torch.bfloat16 else {}
        y1 = gemm(_PC_PLAIN, x, w1, b1, K=ci, N=width)
        y2 = gemm(_PC_TAPS3, y1, w2, b2, K=9 * width, N=width, W=W, C=width)
        if has_ds:
            x = gemm(_PC_CONCAT, y2, w3, b3, K=width + ci, K1=width, N=cout, X2=x, **kw)
        else:
            if ci != cout:
                raise ValueError("bottleneck_chain: identity block needs cin == cout")
            x = gemm(_PC_PLAIN, y2, w3, b3, K=width, N=cout, R=x, **kw)
    return x
