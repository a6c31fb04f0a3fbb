#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sequoia_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels built from ``sequoia_tpu_torch/csrc`` (nvcc,
   ``sm_90a``), with the seconds it took;
3. kernels: each kernel (K1 vis_blocks_fused, K2 stem16, K3
   bottleneck_chain_cp, K5 lloyd_stats) against its plain PyTorch version on
   the card at the main path's shapes, in f32 and bf16 (K5 is f32 only), with
   the error against the stated tolerance, the kernel's time, the plain
   version's, one PyTorch library call's where one computes the same function,
   and the bound (the least time the card could take for the same work);
4. main path: a ``SlidePredictor`` with random ResNet-50 and 5-fold ViS
   weights at full width (D=2048, depth 6, 16 heads, 20,820 genes, bf16),
   ResNet ``early_pallas``, k-means ``use_pallas`` and the fused ViS, runs
   ``predict_patches`` on a 4096-patch and a 60-patch slide of random 256-px
   patches; every launch counter must rise, the outputs must be finite
   (1, 20820), and the same slides through the plain versions must agree.

The last lines are the kernels table, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before the last line.  Without CUDA, or without the package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# the main path's shapes (bench.py's slide: 4096 patches of 256 px, extractor
# batch 128, k = 100 padded to 128 centers, ViS D = 2048 over 100 tokens)
PATCHES, SMALL_SLIDE, PATCH, FEAT_BATCH = 4096, 60, 256, 128
K, KPAD, D, GENES, FOLDS = 100, 128, 2048, 20820, 5

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
       "vis_blocks_fused": {"float32": 1e-4, "bfloat16": 3e-2},
       "lloyd_stats": {"float32": 1e-5}}

SOURCES = {
    "vis_blocks_fused": ("sequoia_tpu_torch/csrc/vis_blocks.cu",
                         "sequoia_tpu/ops/pallas_vis.py:255"),
    "stem16": ("sequoia_tpu_torch/csrc/conv_gemm.cu",
               "sequoia_tpu/ops/pallas_resnet.py:285"),
    "bottleneck_chain_cp": ("sequoia_tpu_torch/csrc/conv_gemm.cu",
                            "sequoia_tpu/ops/pallas_resnet.py:377"),
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


def check_chain(torch, dev, dtype: str) -> dict:
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.ops import cuda_resnet

    g = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, dtype)
    params = resnet.random_params(g)
    H = W = PATCH // 4
    x = torch.relu(torch.randn((FEAT_BATCH, 64, H * W), generator=g, device=dev)).to(dt)
    flat, meta = cuda_resnet.stage_chain_weights_cp(params["layer1"], 0, dt)
    run = lambda: cuda_resnet.bottleneck_chain_cp(x, flat, meta=meta, H=H, W=W)  # noqa: E731
    plain = lambda: cuda_resnet.bottleneck_chain_cp_plain(  # noqa: E731
        x, flat, meta=meta, H=H, W=W)
    out = run()
    res = compare(torch, "bottleneck_chain_cp", dtype, out, plain())
    res.update(ms=time_ms(torch, run, 5), plain_ms=time_ms(torch, plain, 2), library_ms=None)
    flops = 2 * FEAT_BATCH * H * W * sum(ci * w + 9 * w * w + w * co + (ci * co if ds else 0)
                                         for ci, w, co, ds in meta)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes(x, out, *flat), flops, dtype)
    return res


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
    g = torch.Generator(device=dev).manual_seed(4)
    params = vis.init(cfg, g)
    chunks, smalls, pos = cuda_vis.pack_vis_blocks(cfg, params, getattr(torch, dtype))
    x = torch.randn((K, D), generator=g, device=dev)
    kw = dict(depth=cfg.depth, nheads=cfg.nheads)
    run = lambda: cuda_vis.vis_blocks_fused(x, pos, chunks, smalls, **kw)  # noqa: E731
    plain = lambda: cuda_vis.vis_blocks_plain(x, pos, chunks, smalls, **kw)  # noqa: E731
    out = run()
    res = compare(torch, "vis_blocks_fused", dtype, out, plain())
    res.update(ms=time_ms(torch, run, 10), plain_ms=time_ms(torch, plain, 10),
               library_ms=None)
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


def main_path(torch, dev, launches: dict) -> None:
    import numpy as np
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.models import resnet, vis
    from sequoia_tpu_torch.ops import kmeans as km
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor
    from sequoia_tpu_torch.serve import SlidePredictor

    g = torch.Generator(device=dev).manual_seed(0)
    rparams = resnet.random_params(g)
    vcfg = vis.ViSConfig(num_outputs=GENES, input_dim=D, depth=6, nheads=16, dim_f=64,
                         dim_s=64, dim_c=64, num_clusters=K, compute_dtype="bfloat16")
    folds = [(vcfg, vis.init(vcfg, torch.Generator(device=dev).manual_seed(100 + i)))
             for i in range(FOLDS)]
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
    launches.update(_build.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path did not launch {missing}")

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

    # where a slide's time goes: each stage of predict_patches alone, host
    # clock around work that ends in a synchronize
    u8 = slides[PATCHES]
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
        for kname, fn in (("stem16", check_stem16), ("bottleneck_chain_cp", check_chain),
                          ("vis_blocks_fused", check_vis)):
            r = fn(torch, dev, dtype)
            emit({"phase": "kernel", "name": kname, "dtype": dtype, **r})
            results[kname] = r  # the bf16 row (the main path's type) is kept
    r = check_lloyd(torch, dev)
    emit({"phase": "kernel", "name": "lloyd_stats", "dtype": "float32", **r})
    results["lloyd_stats"] = r
    torch.cuda.empty_cache()

    launches = dict.fromkeys(results, 0)
    main_path(torch, dev, launches)

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
