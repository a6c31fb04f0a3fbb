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

On CUDA tensors all three run the CUDA kernels of ``csrc/conv_gemm.cu``
(which says what bounds them on the H100 and what their design does about
it); on CPU tensors they run the plain PyTorch versions beside them.  All
round to the compute type where the Pallas kernels do: after each ReLU of
y1, y2 and the block output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sequoia_tpu_torch import _build

# tap order of the 3x3 stack rows: (dy, dx) lexicographic, as the OIHW kernel
# permuted to (O, kh, kw, I) and flattened
TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

# conv_gemm.cu's operand modes: (C, P) kernels K2/K3, then (P, C) kernel K4
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


def stem16(x16: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, H2: int,
           W2: int) -> torch.Tensor:
    """(B, 16, (H2+3)*W2) -> (B, 64, H2*W2) stem activations (conv + BN +
    ReLU).  The 16 channels are the 12 space-to-depth channels and 4 zero
    ones; the rows carry 2 zero rows on top and 1 below."""
    B, c16, P_in = x16.shape
    if c16 != 16 or P_in != (H2 + 3) * W2 or a.shape != (64, 256):
        raise ValueError(f"stem16: bad shapes x16 {tuple(x16.shape)}, A {tuple(a.shape)}")
    _check("stem16", x16, a, b)
    if not x16.is_cuda:
        return stem16_plain(x16, a, b, H2=H2, W2=W2)
    P = H2 * W2
    x16 = x16.contiguous()
    out = torch.empty((B, 64, P), dtype=x16.dtype, device=x16.device)
    _launch(_STEM, a.to(x16.dtype).contiguous(), b.float().contiguous(), x16, out,
            M=64, K=256, N=P, W=W2, xc=P_in, xs=16 * P_in)
    _build.count_launch("stem16")
    return out


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


def _launch_pc(mode, X, Wt, bias, out, *, K, N, W=1, C=0, X2=None, R=None, K1=0):
    """One (P, C) GEMM per image: out[b] (P, N) = epilogue(Aop(X[b]) . Wt)."""
    lib = _build.library()
    B, P = out.shape[0], out.shape[1]
    rc = lib.sq_pc_gemm(
        1 if X.dtype == torch.bfloat16 else 0, mode, X.data_ptr(),
        None if X2 is None else X2.data_ptr(), Wt.data_ptr(), bias.data_ptr(),
        None if R is None else R.data_ptr(), out.data_ptr(), B, P, K, K1, N, W, C,
        X.stride(0), 0 if X2 is None else X2.stride(0),
        0 if R is None else R.stride(0), out.stride(0), _build.stream_ptr(X))
    _build.check(rc, "pc_gemm")


def bottleneck_chain_plain(x, flat_weights, *, meta, H: int, W: int) -> torch.Tensor:
    """Plain PyTorch (P, C) chain: per block the 1x1 GEMM, the (P, 9*width)
    tap stack GEMM, then the (merged projection or residual) 1x1, each
    followed by ReLU."""
    cd = x.dtype
    for i, (_, _, _, has_ds) in enumerate(meta):
        w1, b1, w2s, b2, w3, b3 = flat_weights[6 * i:6 * i + 6]
        y1 = torch.relu(torch.matmul(x.float(), w1.float()) + b1).to(cd)
        stack = torch.cat([_shifted(y1, W, dy, dx, dim=-2) for dy, dx in TAPS], dim=-1)
        y2 = torch.relu(torch.matmul(stack.float(), w2s.float()) + b2).to(cd)
        if has_ds:
            y3 = torch.matmul(torch.cat([y2, x], dim=-1).float(), w3.float()) + b3
        else:
            y3 = torch.matmul(y2.float(), w3.float()) + b3 + x.float()
        x = torch.relu(y3).to(cd)
    return x


def bottleneck_chain(x: torch.Tensor, flat_weights: tuple, *, meta: tuple, H: int,
                     W: int, row_chunk: int = 512) -> torch.Tensor:
    """(B, H*W, Cin) -> (B, H*W, Cout) through stride-1 bottleneck blocks
    (weights from :func:`stage_chain_weights`).

    ``row_chunk`` keeps the JAX checks (whole image rows, dividing H*W); the
    Pallas kernel chunks rows only to bound its VMEM, and the result does not
    depend on it, so the CUDA kernel tiles the pixels its own way."""
    B, P, cin = x.shape
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
    cd = x.dtype
    x = x.contiguous()
    for i, (ci, width, cout, has_ds) in enumerate(meta):
        w1, b1, w2s, b2, w3, b3 = (t.contiguous() for t in flat_weights[6 * i:6 * i + 6])
        w1, w2s, w3 = w1.to(cd), w2s.to(cd), w3.to(cd)
        y1 = torch.empty((B, P, width), dtype=cd, device=x.device)
        _launch_pc(_PC_PLAIN, x, w1, b1, y1, K=ci, N=width)
        y2 = torch.empty_like(y1)
        _launch_pc(_PC_TAPS3, y1, w2s, b2, y2, K=9 * width, N=width, W=W, C=width)
        out = torch.empty((B, P, cout), dtype=cd, device=x.device)
        if has_ds:
            _launch_pc(_PC_CONCAT, y2, w3, b3, out, K=width + ci, K1=width, N=cout, X2=x)
        else:
            if ci != cout:
                raise ValueError("bottleneck_chain: identity block needs cin == cout")
            _launch_pc(_PC_PLAIN, y2, w3, b3, out, K=width, N=cout, R=x)
        _build.count_launch("bottleneck_chain", 3)
        x = out
    return x
