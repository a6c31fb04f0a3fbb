"""Cells shrunk to a size the CPU runs in seconds, through the program's
plain PyTorch versions: the same files, with a few sizes overridden."""

from __future__ import annotations

import copy

from benchmark import common

TINY = {
    "sequoia-resnet50-vis": {
        "backbone": {"patch_size": 32, "batch_size": 4},
        "kmeans": {"n_clusters": 4},
        "vis": {"depth": 1, "num_outputs": 24, "num_clusters": 4},
        "train": {"batch_size": 4},
    },
    "sequoia-uni-vitl16-vis": {
        "backbone": {"patch_size": 40, "img_size": 32, "patch": 16, "feature_dim": 64,
                     "depth": 2, "heads": 2, "mlp_dim": 128, "batch_size": 4},
        "kmeans": {"n_clusters": 4},
        "vis": {"input_dim": 64, "depth": 1, "nheads": 2, "dim_f": 16, "dim_s": 16,
                "dim_c": 16, "num_outputs": 24, "num_clusters": 4},
    },
}
TINY_TRAFFIC = {
    "slides": {"pool": 48, "cycle": {"full": 16, "full_per_group": 3, "pairs": [[8, 8], [4, 12]]},
               "check": {"full": 1, "other": 1, "rows": 4}, "trace_slides": 2},
    "features": {"pool": 64, "cycle": {"full": 16, "full_per_group": 3, "pairs": [[8, 8], [4, 12]]},
                 "check": {"full": 2, "other": 1}, "trace_slides": 3},
    "train": {"cohort": 40, "tokens": 4, "check_steps": 3, "trace_epochs": 1},
}


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def spec(workload: str, bench_json=None) -> dict:
    s = common.spec(bench_json or common.CHECKOUT / "BENCHMARK.json", workload)
    s["config"] = merge(s["config"], TINY.get(s["config"]["name"], {}))
    s["traffic"] = merge(s["traffic"], TINY_TRAFFIC.get(s["cell"]["traffic"], {}))
    return s
