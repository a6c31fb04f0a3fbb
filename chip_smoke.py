#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sequoia_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels built from ``sequoia_tpu_torch/csrc`` (nvcc,
   ``sm_90a``), with the seconds it took;
3. kernels: each kernel (K1 vis_blocks_fused, K2 stem16, K3
   bottleneck_chain_cp, K4 bottleneck_chain, K5 lloyd_stats) against its
   plain PyTorch version on the card at the main path's shapes, in f32 and
   bf16 (K5 is f32 only), with the error against the stated tolerance, the
   kernel's time, the plain version's, one PyTorch library call's for the
   same function (K1: the plain ``vis`` block loop on cuBLAS; K2, K3, K4:
   cuDNN ``F.conv2d`` + BN + ReLU of the same layers; K5: a distance GEMM,
   argmin and ``index_add_``), and the bound (the least time the card could
   take for the same work).  K3 and K4 (bf16: the tensor-core kernel of
   ``conv_wgmma.cu``; f32: the FMA kernels of ``conv_gemm.cu``) are timed at
   layer1's shape and also checked and timed at the three stage tails
   (layers 2-4 after their stride-2 block) and, in bf16, checked at three
   off-path edge shapes, each with its share of the bound and TFLOP/s; then
   a ``chain_totals`` line (K3 and K4 per extractor batch, layer1 + tails,
   kernel against library), a ``chain_weight_fold`` line (the per-batch cost
   of folding and casting each stage's chain weights, as every forward
   does), and ResNet ``early_pallas`` + ``cp_stages=(2, 3, 4)`` on one batch
   against the plain extractor;
4. main path: a ``SlidePredictor`` with random ResNet-50 and 5-fold ViS
   weights at full width (D=2048, depth 6, 16 heads, 20,820 genes, bf16),
   ResNet ``early_pallas``, k-means ``use_pallas`` and the fused ViS, runs
   ``predict_patches`` on a 4096-patch and a 60-patch slide of random 256-px
   patches; every launch counter must rise, the outputs must be finite
   (1, 20820), and the same slides through the plain versions must agree;
   then a ``torch.profiler`` trace of one extractor batch of each predictor
   (device ms by kernel, idle share) and each stage's time;
5. WSI path: two synthetic AppMag-20 slides (8192 x 8192 level 0 with a
   textured tissue ellipse over about 75% of it, a 4x-down level 1) served
   from the slide with ``predict_wsi`` one by one and ``predict_slides``
   over both: tissue screen -> ResNet-50 with ``fused_stages=(1, 2, 3, 4)``
   (K4) -> k-means (K5) -> 5-fold ViS (K1), against a plain predictor (same
   kept patches, features within 5%, Pearson r >= 0.99), then a run at
   ``max_patches=256`` that must stop decoding early, and the same trace of
   one batch of candidates.

The last lines are the kernels table (``launches`` sums the counts of the
two paths' runs, each read from 0), the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before the last line.  Without CUDA, or without the package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

# the main path's shapes (bench.py's slide: 4096 patches of 256 px, extractor
# batch 128, k = 100 padded to 128 centers, ViS D = 2048 over 100 tokens)
PATCHES, SMALL_SLIDE, PATCH, FEAT_BATCH = 4096, 60, 256, 128
K, KPAD, D, GENES, FOLDS = 100, 128, 2048, 20820, 5
# the ResNet chain shapes at 256 px: (stage, first stride-1 block, map side)
CHAIN_LAYER1, CHAIN_TAILS = (1, 0, 64), ((2, 1, 32), (3, 1, 16), (4, 1, 8))
# off-path chain shapes for the edges of the bf16 tensor-core kernel: (batch,
# stage, first block, H, W): a projection block first over 8 x 16 maps, one
# 8 x 8 image (fewer rows than a tile), and 9 x 15 maps (tiles that straddle
# images, a ragged last tile)
CHAIN_EDGES = ((3, 1, 0, 8, 16), (1, 4, 1, 8, 8), (2, 2, 0, 9, 15))
# the WSI path: level-0 side, the early-stop run's cap
WSI_SIDE, WSI_CAP = 8192, 256

# card peaks (H100 SXM data sheet, dense): the bound of a kernel is the
# larger of bytes / HBM rate and operations / peak rate for their type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# kernel vs plain version on the same inputs: max |kernel - plain| / max |plain|.
# f32: the two sum in different orders (f32 rounding only).  bf16: both round
# to bf16 at the same points, but a value that lands on a rounding boundary
# can round one ulp (2^-8) apart and carry into the next GEMM.
TOL = {"stem16": {"float32": 1e-5, "bfloat16": 1e-2},
       "bottleneck_chain_cp": {"float32": 1e-4, "bfloat16": 3e-2},
       "bottleneck_chain": {"float32": 1e-4, "bfloat16": 3e-2},
       "vis_blocks_fused": {"float32": 1e-4, "bfloat16": 3e-2},
       "lloyd_stats": {"float32": 1e-5}}

SOURCES = {
    "vis_blocks_fused": ("sequoia_tpu_torch/csrc/vis_blocks.cu",
                         "sequoia_tpu/ops/pallas_vis.py:255"),
    "stem16": ("sequoia_tpu_torch/csrc/conv_gemm.cu",
               "sequoia_tpu/ops/pallas_resnet.py:285"),
    # the kernels line reports K3/K4's bf16 row: the tensor-core kernel (f32
    # runs the FMA kernels of conv_gemm.cu)
    "bottleneck_chain_cp": ("sequoia_tpu_torch/csrc/conv_wgmma.cu",
                            "sequoia_tpu/ops/pallas_resnet.py:377"),
    "bottleneck_chain": ("sequoia_tpu_torch/csrc/conv_wgmma.cu",
                         "sequoia_tpu/ops/pallas_resnet.py:151"),
    "lloyd_stats": ("sequoia_tpu_torch/csrc/lloyd_stats.cu",
                    "sequoia_tpu/ops/pallas_kmeans.py:81"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_batch(torch, fn, iters: int = 3) -> dict:
    """Device time of fn (one extractor batch) by kernel name from a
    torch.profiler trace, and the device's idle share of the traced window
    (host clock, ending in a synchronize; the profiler's own host cost is in
    the window, so the share is an upper estimate)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # warm-up: the tracer's own start-up stays out
        fn()
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms_per_batch": wall_ms / iters, "device_ms_per_batch": busy_ms / iters,
            "idle_share": 1 - busy_ms / wall_ms,
            "device_events_per_batch": sum(n for _, n in by_name.values()) / iters,
            "top": [{"kernel": k[:90], "ms_per_batch": ms / iters, "calls_per_batch": n / iters}
                    for k, (ms, n) in top]}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def compare(torch, name, dtype, got, want) -> dict:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} {dtype}: kernel output not finite")
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1e-30)
    rel = err / scale
    tol = TOL[name][dtype]
    if rel > tol:
        raise AssertionError(f"{name} {dtype}: max|kernel-plain|/max|plain| = {rel:.3g} "
                             f"> {tol:g}")
    return {"max_abs_err": err, "max_rel_err": rel, "tol": tol}


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def check_stem16(torch, dev, dtype: str) -> dict:
    import torch.nn.functional as F
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.ops import cuda_resnet

    g = torch.Generator(device=dev).manual_seed(1)
    dt = getattr(torch, dtype)
    params = resnet.random_params(g)
    img = torch.randn((FEAT_BATCH, PATCH, PATCH, 3), generator=g, device=dev).to(dt)
    h2 = w2 = PATCH // 2
    x16 = F.pad(resnet._space_to_depth(img), (0, 0, 2, 1, 0, 4)).reshape(
        FEAT_BATCH, 16, (h2 + 3) * w2).contiguous()
    a, b = cuda_resnet.fold_stem16_weights(params["conv1_s2d"], params["bn1"], dt)
    run = lambda: cuda_resnet.stem16(x16, a, b, H2=h2, W2=w2)  # noqa: E731
    plain = lambda: cuda_resnet.stem16_plain(x16, a, b, H2=h2, W2=w2)  # noqa: E731
    out = run()
    res = compare(torch, "stem16", dtype, out, plain())
    # yardstick: cuDNN's 7x7/s2 conv + BN + ReLU on the same image batch
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    w = params["conv1"].to(dt)
    s = params["bn1"]["scale"].to(dt)[:, None, None]
    bb = params["bn1"]["bias"].to(dt)[:, None, None]
    lib = lambda: torch.relu(F.conv2d(img_nchw, w, stride=2, padding=3) * s + bb)  # noqa: E731
    p_out = h2 * w2
    res.update(ms=time_ms(torch, run, 10), plain_ms=time_ms(torch, plain, 2),
               library_ms=time_ms(torch, lib, 10))
    res["bound_ms"], res["bound_by"] = bound_ms(
        nbytes(x16, a, b, out), 2 * FEAT_BATCH * 64 * 256 * p_out, dtype)
    return res


def check_chain(torch, dev, dtype: str, kname: str) -> dict:
    """K3 (``bottleneck_chain_cp``, (C, P)) or K4 (``bottleneck_chain``,
    (P, C)) against its plain version at layer1 and the three stage tails
    and, in bf16 (the tensor-core route), at the off-path edge shapes; the
    row's numbers are layer1's, the tails' go under ``tails``, the edges'
    under ``edges``."""
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.ops import cuda_resnet as cr

    pc = kname == "bottleneck_chain"
    fold, kernel, plain_fn = ((cr.stage_chain_weights, cr.bottleneck_chain,
                               cr.bottleneck_chain_plain) if pc else
                              (cr.stage_chain_weights_cp, cr.bottleneck_chain_cp,
                               cr.bottleneck_chain_cp_plain))
    g = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, dtype)
    params = resnet.random_params(g)
    shapes = [(FEAT_BATCH, stage, start, H, H) for stage, start, H in (CHAIN_LAYER1,
                                                                       *CHAIN_TAILS)]
    if dtype == "bfloat16":
        shapes += CHAIN_EDGES
    res, tails, edges = None, [], []
    for batch, stage, start, H, W in shapes:
        blocks = params[f"layer{stage}"]
        flat, meta = fold(blocks, start, dt)
        x = torch.relu(torch.randn((batch, meta[0][0], H * W), generator=g,
                                   device=dev)).to(dt)
        xk = x.transpose(1, 2).contiguous() if pc else x
        run = lambda: kernel(xk, flat, meta=meta, H=H, W=W)  # noqa: E731
        plain = lambda: plain_fn(xk, flat, meta=meta, H=H, W=W)  # noqa: E731
        out = run()
        r = compare(torch, kname, dtype, out, plain())
        # yardstick: cuDNN's conv + BN + ReLU chain of the same blocks (the
        # plain extractor's own loop), in the layout the kernel's path uses
        x4 = x.reshape(batch, -1, H, W).contiguous(
            memory_format=torch.channels_last if pc else torch.contiguous_format)

        def lib(x4=x4, blocks=blocks[start:]):
            for blk in blocks:
                x4 = resnet._bottleneck(x4, blk, 1)
            return x4

        flops = 2 * batch * H * W * sum(ci * w + 9 * w * w + w * co + (ci * co if ds else 0)
                                        for ci, w, co, ds in meta)
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes(x, out, *flat), flops, dtype)
        r.update(ms=time_ms(torch, run, 10), library_ms=time_ms(torch, lib, 10))
        r.update(bound_share=r["bound_ms"] / r["ms"], tflops=flops / r["ms"] / 1e9)
        if (batch, stage, start, H) == (FEAT_BATCH, *CHAIN_LAYER1):
            r["plain_ms"] = time_ms(torch, plain, 2)
            res = r
        elif batch == FEAT_BATCH:
            tails.append({"stage": stage, "map": H, **r})
        else:
            edges.append({"batch": batch, "stage": stage, "first_block": start,
                          "map": [H, W], **r})
    res["tails"], res["edges"] = tails, edges
    return res


def chain_totals(results: dict) -> dict:
    """K3's and K4's per-extractor-batch time (layer1 + the three tails),
    kernel against library, from their bf16 rows."""
    out = {}
    for kname in ("bottleneck_chain", "bottleneck_chain_cp"):
        rows = [results[kname], *results[kname]["tails"]]
        out[kname] = {key: sum(r[key] for r in rows)
                      for key in ("ms", "library_ms", "bound_ms")}
        out[kname]["kernel_over_library"] = out[kname]["ms"] / out[kname]["library_ms"]
    return out


def time_weight_folds(torch, dev) -> dict:
    """The per-batch cost of folding and casting the chain weights, which
    models/resnet.py does on every forward (stage_chain_weights* per chained
    stage: layer1 from block 0, the tails from block 1), bf16, device ms per
    stage and in all."""
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.ops import cuda_resnet as cr

    params = resnet.random_params(torch.Generator(device=dev).manual_seed(8))
    out = {}
    for kname, fold in (("bottleneck_chain", cr.stage_chain_weights),
                        ("bottleneck_chain_cp", cr.stage_chain_weights_cp)):
        ms = {f"layer{stage}": time_ms(torch, lambda fold=fold, stage=stage, start=start: fold(
            params[f"layer{stage}"], start, torch.bfloat16), 5)
              for stage, start, _ in (CHAIN_LAYER1, *CHAIN_TAILS)}
        out[kname] = {**ms, "all": sum(ms.values())}
    return out


def check_cp_stages(torch, dev) -> dict:
    """ResNet-50 ``early_pallas`` + ``cp_stages=(2, 3, 4)`` (K2 + K3 over
    every stride-1 run) on one batch against the plain extractor."""
    from sequoia_tpu_torch.models import resnet

    g = torch.Generator(device=dev).manual_seed(5)
    params = resnet.random_params(g)
    u8 = torch.randint(0, 256, (FEAT_BATCH, PATCH, PATCH, 3), generator=g, device=dev,
                       dtype=torch.uint8)
    cfg = dict(compute_dtype=torch.bfloat16)
    got = resnet.extract_from_uint8(
        resnet.ResNetConfig(early_pallas=True, cp_stages=(2, 3, 4), **cfg), params, u8)
    want = resnet.extract_from_uint8(resnet.ResNetConfig(**cfg), params, u8)
    rel = float((got - want).abs().max() / want.abs().max())
    if not bool(torch.isfinite(got).all()) or rel > 0.05:
        raise AssertionError(f"cp_stages extractor: max rel diff {rel:.3g} > 0.05")
    return {"shape": list(got.shape), "max_rel_diff_vs_plain": rel, "tol": 0.05}


def check_lloyd(torch, dev) -> dict:
    import torch.nn.functional as F
    from sequoia_tpu_torch.ops import cuda_kmeans

    g = torch.Generator(device=dev).manual_seed(3)
    # clustered points near their centers, as in the Lloyd steps of a slide,
    # so that no point sits on a near-tie that f32 summation order could flip
    true = torch.randn((K, D), generator=g, device=dev)
    lab = torch.randint(0, K, (PATCHES,), generator=g, device=dev)
    x = true[lab] + 0.1 * torch.randn((PATCHES, D), generator=g, device=dev)
    centers = true + 0.01 * torch.randn((K, D), generator=g, device=dev)
    cpad = F.pad(centers, (0, 0, 0, KPAD - K), value=1e8)
    mask = torch.ones((PATCHES,), dtype=torch.bool, device=dev)
    mask[-96:] = False  # ragged valid count: masked rows contribute nothing
    run = lambda: cuda_kmeans.lloyd_stats(x, mask, cpad)  # noqa: E731
    plain = lambda: cuda_kmeans.lloyd_stats_plain(x, mask, cpad)  # noqa: E731
    (s1, c1, i1, b1), (s2, c2, i2, b2) = run(), plain()
    if not torch.equal(c1, c2):
        raise AssertionError("lloyd_stats: counts differ from the plain version")
    if bool(b1[-96:].ne(0).any()):
        raise AssertionError("lloyd_stats: masked rows have best != 0")
    res = compare(torch, "lloyd_stats", "float32", s1, s2)
    tol = TOL["lloyd_stats"]["float32"]
    if float((i1 - i2).abs() / i2.abs()) > tol:
        raise AssertionError(f"lloyd_stats: inertia {float(i1)} vs {float(i2)}")
    # best = |x|^2 + |c|^2 - 2 x.c cancels most digits for a point near its
    # center: it is exact only to f32 precision of those terms
    terms = float((x * x).sum(1).max() + (centers * centers).sum(1).max())
    if float((b1 - b2).abs().max()) > tol * terms:
        raise AssertionError("lloyd_stats: best differs from the plain version")
    for n in (SMALL_SLIDE, 1007):  # ragged point counts: the kernel masks its edge
        (rs, rc, _, _), (ps, pc, _, _) = (cuda_kmeans.lloyd_stats(x[:n], mask[:n], cpad),
                                          cuda_kmeans.lloyd_stats_plain(x[:n], mask[:n], cpad))
        if not torch.equal(rc, pc) or float((rs - ps).abs().max()) > tol * float(
                ps.abs().max()):
            raise AssertionError(f"lloyd_stats: N={n} differs from the plain version")

    def lib():  # yardstick: distance GEMM + argmin + index_add_ + bincount
        d2 = (x * x).sum(1, keepdim=True) + (cpad * cpad).sum(1) - 2.0 * (x @ cpad.T)
        lbl = torch.argmin(d2, 1)
        sums = torch.zeros_like(cpad).index_add_(0, lbl[mask], x[mask])
        return sums, torch.bincount(lbl[mask], minlength=KPAD)

    res.update(ms=time_ms(torch, run, 20), plain_ms=time_ms(torch, plain, 20),
               library_ms=time_ms(torch, lib, 20))
    n_valid = int(mask.sum())
    flops = 2 * PATCHES * D * KPAD + n_valid * D  # distances + member-row sums
    res["bound_ms"], res["bound_by"] = bound_ms(
        nbytes(x, mask, cpad, s1, c1, i1, b1), flops, "float32")
    return res


def check_vis(torch, dev, dtype: str) -> dict:
    from sequoia_tpu_torch.models import vis
    from sequoia_tpu_torch.ops import cuda_vis

    cfg = vis.ViSConfig(num_outputs=GENES, input_dim=D, num_clusters=K)
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(4)
    params = vis.init(cfg, g)
    chunks, smalls, pos = cuda_vis.pack_vis_blocks(cfg, params, getattr(torch, dtype))
    x = torch.randn((K, D), generator=g, device=dev)
    kw = dict(depth=cfg.depth, nheads=cfg.nheads)
    run = lambda: cuda_vis.vis_blocks_fused(x, pos, chunks, smalls, **kw)  # noqa: E731
    plain = lambda: cuda_vis.vis_blocks_plain(x, pos, chunks, smalls, **kw)  # noqa: E731
    out = run()
    res = compare(torch, "vis_blocks_fused", dtype, out, plain())
    # yardstick: the plain ViS block loop (pos-emb add and the blocks of
    # vis.apply, cuBLAS GEMMs) on the same tokens
    # with its weight matrices already in the compute type, as K1's are
    vcfg = dataclasses.replace(cfg, compute_dtype=dtype)
    blocks = [{k: v[i].to(dt) if k.startswith("w") else v[i] for k, v in params["blocks"].items()}
              for i in range(cfg.depth)]
    pos_emb = params["pos_emb"].to(dt)

    def lib():
        y = x[None].to(dt) + pos_emb
        for bp in blocks:
            y = vis._block(vcfg, y, bp)
        return y

    res.update(ms=time_ms(torch, run, 10), plain_ms=time_ms(torch, plain, 10),
               library_ms=time_ms(torch, lib, 10))
    p, hw, item = D // 2, D // 2 // cfg.nheads, chunks.element_size()
    weights = cfg.depth * (14 * p * p + 2 * p * hw)  # the diagonal of the combine only
    # every weight meets each of the K tokens, but the summary's share of the
    # combine (p * hw per block) meets only the one token-mean row
    flops = 2 * K * weights - 2 * (K - 1) * cfg.depth * p * hw
    res["bound_ms"], res["bound_by"] = bound_ms(
        weights * item + nbytes(smalls, x, pos, out), flops, dtype)
    return res


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def pearson(np, a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def models(torch, dev):
    """Random ResNet-50 and 5-fold ViS weights at full width, from seeds."""
    from sequoia_tpu_torch.models import resnet, vis

    rparams = resnet.random_params(torch.Generator(device=dev).manual_seed(0))
    vcfg = vis.ViSConfig(num_outputs=GENES, input_dim=D, depth=6, nheads=16, dim_f=64,
                         dim_s=64, dim_c=64, num_clusters=K, compute_dtype="bfloat16")
    folds = [(vcfg, vis.init(vcfg, torch.Generator(device=dev).manual_seed(100 + i)))
             for i in range(FOLDS)]
    return rparams, folds


def check_launched(launches: dict, kernels, path: str) -> None:
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path} did not launch {missing}")


def main_path(torch, dev, rparams, folds) -> dict:
    """Phase 4; returns the kernels' launch counts of the kernel path's run."""
    import numpy as np
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.ops import kmeans as km
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor
    from sequoia_tpu_torch.serve import SlidePredictor

    g = torch.Generator(device=dev).manual_seed(6)
    slides = {n: torch.randint(0, 256, (n, PATCH, PATCH, 3), generator=g, device=dev,
                               dtype=torch.uint8) for n in (PATCHES, SMALL_SLIDE)}

    def predictor(kernels: bool) -> SlidePredictor:
        rcfg = resnet.ResNetConfig(compute_dtype=torch.bfloat16, early_pallas=kernels)
        ext = FeatureExtractor("resnet", rparams, batch_size=FEAT_BATCH, cfg=rcfg, device=dev)
        return SlidePredictor(ext, folds, n_clusters=K, use_pallas_kmeans=kernels,
                              use_fused_vis=kernels, device=dev)

    fast, plain = predictor(True), predictor(False)
    for p in (fast, plain):  # warm-up: cuDNN plans, allocator
        p.predict_patches(slides[SMALL_SLIDE])
    torch.cuda.synchronize()

    preds, secs, per_slide = {}, {}, {}
    _build.reset_launches()
    for n, u8 in slides.items():
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        preds[n] = fast.predict_patches(u8)
        torch.cuda.synchronize()
        secs[n] = time.perf_counter() - t0
        per_slide[n] = {k: _build.LAUNCHES[k] - before[k] for k in before}
    launches = dict(_build.LAUNCHES)
    check_launched(launches, ("stem16", "bottleneck_chain_cp", "vis_blocks_fused",
                              "lloyd_stats"), "main path")

    for n, u8 in slides.items():
        y = preds[n]
        if y.shape != (1, GENES) or not np.isfinite(y).all():
            raise AssertionError(f"{n}-patch slide: prediction {y.shape}, finite="
                                 f"{bool(np.isfinite(y).all())}")
        t0 = time.perf_counter()
        ref = plain.predict_patches(u8)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        # stage by stage on shared inputs, so a k-means label flip in one
        # path does not hide a kernel fault: features, then ViS on one set of
        # cluster features
        f_fast, f_plain = fast.extractor.features(u8), plain.extractor.features(u8)
        feat_rel = float((f_fast - f_plain).abs().max() / f_plain.abs().max())
        cf = plain.cluster(f_plain)
        vis_r = pearson(np, fast.predict_cluster_features(cf),
                        plain.predict_cluster_features(cf))
        r = pearson(np, y, ref)
        rel = float(np.abs(y - ref).max() / np.abs(ref).max())
        emit({"phase": "main_path", "patches": n, "shape": list(y.shape), "finite": True,
              "seconds": secs[n], "plain_seconds": plain_s, "launches": per_slide[n],
              "pearson_r_vs_plain": r, "max_rel_diff_vs_plain": rel,
              "features_max_rel_diff": feat_rel, "vis_pearson_r_same_clusters": vis_r})
        if vis_r < 0.999 or feat_rel > 0.05 or r < 0.99:
            raise AssertionError(f"{n}-patch slide disagrees with the plain path")

    # where a slide's time goes: one extractor batch traced, then each stage
    # of predict_patches alone, host clock around work that ends in a
    # synchronize
    u8 = slides[PATCHES]
    for label, p in (("kernels", fast), ("plain", plain)):
        emit({"phase": "profile", "path": "from_patches", "predictor": label,
              "batch": FEAT_BATCH, **profile_batch(torch, lambda p=p: p.extractor.raw_fwd(
                  p.extractor.params, u8[:FEAT_BATCH]))})
    for label, p in (("kernels", fast), ("plain", plain)):
        stages = {}

        def stage(key, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            stages[key] = time.perf_counter() - t0
            return out

        before = _build.LAUNCHES["lloyd_stats"]
        f = stage("features_s", p.extractor.features, u8)
        cf = stage("kmeans_s", p.cluster, f)
        steps = (_build.LAUNCHES["lloyd_stats"] - before) // 2 or None
        # kmeans++ seeding + final assignment alone (no Lloyd step): the rest
        # of kmeans_s is the Lloyd loop, one host sync per step
        mask = torch.ones((f.shape[0],), dtype=torch.bool, device=dev)
        stage("kmeans_seeding_s", km.kmeans_fit, f, mask,
              torch.Generator(device=dev).manual_seed(0), K, 0)
        stage("vis_folds_s", p.predict_cluster_features, cf)
        emit({"phase": "stages", "path": label, "patches": PATCHES, **stages,
              "lloyd_steps": steps})
    return launches


# ---------------------------------------------------------------------------
# phase 5: serving from a whole-slide image
# ---------------------------------------------------------------------------

def make_slide(torch, dev, seed: int):
    """A synthetic AppMag-20 slide: an 8192 x 8192 level 0 of background
    (242) with a textured tissue ellipse over about 75% of it (the colour
    and texture of tests/test_pipeline_e2e.synthetic_wsi), and a 4x-down
    level 1, built on the card from a seed and held on the host."""
    from sequoia_tpu_torch.data.wsi import ArrayReader

    g = torch.Generator(device=dev).manual_seed(seed)
    n = WSI_SIDE
    ys = torch.arange(n, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(n, device=dev, dtype=torch.float32)[None, :]
    ellipse = ((ys - n * (0.5 + 0.01 * seed)) / (0.5 * n)) ** 2 + (
        (xs - n / 2) / (0.49 * n)) ** 2 < 1
    tex = torch.randint(-40, 40, (n, n, 3), generator=g, device=dev, dtype=torch.int16)
    tissue = (torch.tensor([188, 105, 160], dtype=torch.int16, device=dev) + tex
              ).clamp(0, 255).to(torch.uint8)
    lv0 = torch.where(ellipse[..., None], tissue, torch.full_like(tissue, 242))
    levels = [lv0.cpu().numpy(), lv0[::4, ::4].cpu().numpy()]
    return ArrayReader(levels, properties={"aperio.AppMag": "20"})


def wsi_path(torch, dev, rparams, folds) -> dict:
    """Phase 5; returns the kernels' launch counts of the kernel path's run."""
    import numpy as np
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.ops import masking
    from sequoia_tpu_torch.pipeline import patch_gen
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor
    from sequoia_tpu_torch.serve import SlidePredictor

    slides = [make_slide(torch, dev, s) for s in (1, 2)]

    def predictor(kernels: bool, **kw) -> SlidePredictor:
        rcfg = resnet.ResNetConfig(compute_dtype=torch.bfloat16,
                                   fused_stages=(1, 2, 3, 4) if kernels else ())
        ext = FeatureExtractor("resnet", rparams, batch_size=FEAT_BATCH, cfg=rcfg,
                               patch_size=PATCH, device=dev)
        return SlidePredictor(ext, folds, n_clusters=K, use_pallas_kmeans=kernels,
                              use_fused_vis=kernels, patch_size=PATCH, device=dev, **kw)

    def capture(p) -> list:
        """Record the kept features each predict_features call receives."""
        seen, orig = [], p.predict_features

        def spy(feats):
            seen.append(feats)
            return orig(feats)

        p.predict_features = spy
        return seen

    fast, plain = predictor(True), predictor(False)
    warm = torch.randint(0, 256, (SMALL_SLIDE, PATCH, PATCH, 3), device=dev,
                         dtype=torch.uint8, generator=torch.Generator(device=dev).manual_seed(7))
    for p in (fast, plain):  # warm-up: cuDNN plans for channels_last, allocator
        p.predict_patches(warm)
    n_cands = [len(fast._candidates(s)[1]) for s in slides]
    torch.cuda.synchronize()

    def serve(p, label: str) -> dict:
        feats = capture(p)
        out = {"preds": [], "seconds": [], "kept": [], "launches": []}
        for s in slides:
            before, kept0 = dict(_build.LAUNCHES), p.io_stats["kept"]
            t0 = time.perf_counter()
            out["preds"].append(p.predict_wsi(s))
            torch.cuda.synchronize()
            out["seconds"].append(time.perf_counter() - t0)
            out["kept"].append(p.io_stats["kept"] - kept0)
            out["launches"].append({k: _build.LAUNCHES[k] - before[k] for k in before})
        t0 = time.perf_counter()
        out["slides"] = list(p.predict_slides(slides))
        torch.cuda.synchronize()
        out["slides_seconds"] = time.perf_counter() - t0
        out["feats"] = feats[:len(slides)]
        del p.predict_features
        return out

    _build.reset_launches()
    got = serve(fast, "kernels")
    launches = dict(_build.LAUNCHES)
    check_launched(launches, ("bottleneck_chain", "lloyd_stats", "vis_blocks_fused"),
                   "WSI path")
    ref = serve(plain, "plain")

    for i in range(len(slides)):
        y, want = got["preds"][i], ref["preds"][i]
        if y.shape != (1, GENES) or not np.isfinite(y).all():
            raise AssertionError(f"WSI slide {i}: prediction {y.shape} not finite (1, G)")
        fa, fb = got["feats"][i], ref["feats"][i]
        feat_rel = float((fa - fb).abs().max() / fb.abs().max())
        r = pearson(np, y, want)
        r_slides = pearson(np, got["slides"][i][1], y)
        emit({"phase": "wsi", "slide": i, "level0": [WSI_SIDE, WSI_SIDE],
              "candidates": n_cands[i], "kept": got["kept"][i], "kept_plain": ref["kept"][i],
              "seconds": got["seconds"][i], "plain_seconds": ref["seconds"][i],
              "launches": got["launches"][i], "features_max_rel_diff": feat_rel,
              "pearson_r_vs_plain": r, "pearson_r_predict_slides_vs_wsi": r_slides})
        if got["kept"][i] != ref["kept"][i] or not 0 < got["kept"][i] <= n_cands[i]:
            raise AssertionError(f"WSI slide {i}: kept {got['kept'][i]} vs plain "
                                 f"{ref['kept'][i]} of {n_cands[i]} candidates")
        if feat_rel > 0.05 or r < 0.99 or r_slides < 0.99:
            raise AssertionError(f"WSI slide {i} disagrees with the plain path")

    # decoding stops once max_patches are kept
    capped = predictor(True, max_patches=WSI_CAP)
    decoded, orig = [], capped._decode_chunks

    def counting(candidates, decode_chunk=64, stop=None):
        for chunk in orig(candidates, decode_chunk, stop):
            decoded.append(len(chunk))
            yield chunk

    capped._decode_chunks = counting
    y = capped.predict_wsi(slides[0])
    if capped.io_stats["kept"] != WSI_CAP or sum(decoded) >= n_cands[0]:
        raise AssertionError(f"max_patches={WSI_CAP}: kept {capped.io_stats['kept']}, "
                             f"decoded {sum(decoded)} of {n_cands[0]} candidates")
    # where a slide's time goes: the slide mask + candidate grid, then per
    # batch of candidates the tissue screen and the backbone alone
    t0 = time.perf_counter()
    cands = fast._candidates(slides[0])
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - t0
    batch = torch.as_tensor(next(fast._decode_chunks(cands, FEAT_BATCH)), device=dev)
    screen_ms = time_ms(torch, lambda: masking.patch_keep_flags(
        batch, background_threshold=patch_gen.BACKGROUND_THRESHOLD), 5)
    backbone_ms = {label: time_ms(torch, lambda p=p: p.extractor.raw_fwd(
        p.extractor.params, batch), 3) for label, p in (("kernels", fast), ("plain", plain))}
    for label, p in (("kernels", fast), ("plain", plain)):
        emit({"phase": "profile", "path": "wsi", "predictor": label, "batch": FEAT_BATCH,
              **profile_batch(torch, lambda p=p: p.extractor.raw_fwd(p.extractor.params,
                                                                     batch))})
    emit({"phase": "wsi_summary", "slides": len(slides),
          "seconds_per_slide": sum(got["seconds"]) / len(slides),
          "plain_seconds_per_slide": sum(ref["seconds"]) / len(slides),
          "predict_slides_seconds": got["slides_seconds"],
          "plain_predict_slides_seconds": ref["slides_seconds"],
          "bottleneck_chain_launches_per_slide": [
              lc["bottleneck_chain"] for lc in got["launches"]],
          "mask_and_grid_s": mask_s, "screen_ms_per_batch": screen_ms,
          "backbone_ms_per_batch": backbone_ms, "batch": FEAT_BATCH,
          "capped_run": {"max_patches": WSI_CAP, "kept": capped.io_stats["kept"],
                         "decoded": sum(decoded), "candidates": n_cands[0],
                         "finite": bool(np.isfinite(y).all())}})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.ops.nn import precision

    precision()  # TF32 off: f32 means IEEE f32 for the plain versions too
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_build.build().relative_to(_build.BUILD_DIR.parent.parent))})

    results = {}
    for dtype in ("float32", "bfloat16"):
        for kname, fn in (("stem16", check_stem16),
                          ("bottleneck_chain_cp",
                           functools.partial(check_chain, kname="bottleneck_chain_cp")),
                          ("bottleneck_chain",
                           functools.partial(check_chain, kname="bottleneck_chain")),
                          ("vis_blocks_fused", check_vis)):
            r = fn(torch, dev, dtype)
            emit({"phase": "kernel", "name": kname, "dtype": dtype, **r})
            results[kname] = r  # the bf16 row (the main path's type) is kept
    r = check_lloyd(torch, dev)
    emit({"phase": "kernel", "name": "lloyd_stats", "dtype": "float32", **r})
    results["lloyd_stats"] = r
    emit({"phase": "chain_totals", "dtype": "bfloat16", "per": "extractor batch",
          **chain_totals(results)})
    emit({"phase": "chain_weight_fold", "dtype": "bfloat16", "per": "extractor batch",
          **time_weight_folds(torch, dev)})
    emit({"phase": "extractor_cp_stages", **check_cp_stages(torch, dev)})
    torch.cuda.empty_cache()

    rparams, folds = models(torch, dev)
    main = main_path(torch, dev, rparams, folds)
    torch.cuda.empty_cache()
    wsi = wsi_path(torch, dev, rparams, folds)
    launches = {k: main[k] + wsi[k] for k in results}

    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1],
         "launches": launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]} for k, r in results.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
