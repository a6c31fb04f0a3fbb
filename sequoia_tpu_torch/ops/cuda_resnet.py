"""ResNet early-stage kernels in the (C, P) layout: K2 ``stem16`` and K3
``bottleneck_chain_cp``.

Counterpart of ``sequoia_tpu/ops/pallas_resnet.py:201-421`` (the (C, P)
half; the (P, C) ``bottleneck_chain`` is not ported yet, see ROADMAP.md).
Same layouts as the JAX functions: ``stem16`` takes the row-padded
space-to-depth input ``(B, 16, (H2+3)*W2)`` and returns ``(B, 64, H2*W2)``;
``bottleneck_chain_cp`` takes and returns ``(B, C, H*W)``.  The weight
folding functions take the port's OIHW conv weights.

On CUDA tensors both run the CUDA kernel of ``csrc/conv_gemm.cu`` (which
says what bounds it on the H100 and what its design does about it); on CPU
tensors they run the plain PyTorch versions beside them.  Both round to the
compute type where the Pallas kernels do: after each ReLU of y1, y2 and the
block output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sequoia_tpu_torch import _build

# tap order of the 3x3 stack rows: (dy, dx) lexicographic, as the OIHW kernel
# permuted to (O, kh, kw, I) and flattened
TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

_PLAIN, _TAPS3, _STEM, _CONCAT = 0, 1, 2, 3


def _mm(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(M, K) . (B, K, P) -> (B, M, P) f32 from compute-type operands."""
    return torch.matmul(w.float(), x.float())


def _shifted(y: torch.Tensor, W: int, dy: int, dx: int) -> torch.Tensor:
    """y[..., q + dy*W + dx] at pixel q of a (B, C, P) map, zero where the
    source leaves the image."""
    P = y.shape[-1]
    d = dy * W + dx
    q = torch.arange(P, device=y.device)
    col = q % W + dx
    src = q + d
    ok = (col >= 0) & (col < W) & (src >= 0) & (src < P)
    rolled = torch.roll(y, shifts=-d, dims=-1) if d else y
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
