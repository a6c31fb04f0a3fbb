"""Serving-latency microbench: the B = 1 fold-ensemble ViS forward, full head
against a gene panel.

Counterpart of ``tools/bench_serving.py``.  It measures what a resident
server pays per slide after features and k-means, the fold-ensembled ViS
forward, and what slicing the head to a panel changes (at B = 1 the (D, G)
head read dominates the head's cost).  ``--kernels on`` runs the folds'
blocks through the K1 kernel on CUDA, ``off`` through the plain ``vis``
loop.

    python -m sequoia_tpu_torch.bench_serving                  # 5 folds, G = 20,820, CUDA
    python -m sequoia_tpu_torch.bench_serving --kernels off --device cpu --reps 2

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--kernels", default="on", choices=["on", "off"],
                    help="the ViS blocks through the K1 kernel (on) or plain (off)")
    ap.add_argument("--genes", type=int, default=20820)
    ap.add_argument("--panel", type=int, default=50)
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--input_dim", type=int, default=2048)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from sequoia_tpu_torch.models import vis
    from sequoia_tpu_torch.serve import SlidePredictor
    from sequoia_tpu_torch.utils.device import resolve_device

    dev = resolve_device(None if args.device == "cuda" else args.device)
    dtype = None if args.compute_dtype == "float32" else args.compute_dtype
    cfg = vis.ViSConfig(num_outputs=args.genes, input_dim=args.input_dim, depth=args.depth,
                        compute_dtype=dtype)
    models = [(cfg, vis.init(cfg, torch.Generator().manual_seed(i))) for i in range(args.folds)]
    cf = np.random.default_rng(0).normal(
        size=(1, cfg.num_clusters, args.input_dim)).astype(np.float32)
    kernels = args.kernels == "on" and dev.type == "cuda"

    def time_predictor(ms):
        pred = SlidePredictor(None, ms, n_clusters=cfg.num_clusters, use_fused_vis=kernels,
                              device=dev)
        pred.predict_cluster_features(cf)  # warm-up
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = pred.predict_cluster_features(cf)  # returns numpy: synchronizes
        return (time.perf_counter() - t0) / args.reps, out.shape

    full_s, full_shape = time_predictor(models)
    idx = list(range(args.panel))
    panel_s, panel_shape = time_predictor([vis.slice_head(c, p, idx) for c, p in models])
    res = {"metric": "vis_b1_latency_ms", "device": dev.type,
           "name": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
           "kernels": "vis_blocks_fused" if kernels else "none", "folds": args.folds,
           "compute_dtype": args.compute_dtype,
           "full_head": {"genes": full_shape[-1], "ms": full_s * 1e3},
           "panel": {"genes": panel_shape[-1], "ms": panel_s * 1e3},
           "speedup": full_s / panel_s}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
