"""The control of each cell's check: the plain reference put in the
program's place, computed one precision below what the configuration
states (fp8 e4m3 for the bf16 backbone and folds, TF32 for the f32
k-means and the f32 training step), read by the same numbers as the
program, on the same slides, batches and weights a run of that seed draws.
For the training cell also the fault "half of the batch left out": the f32
reference with the second half of each batch's rows masked.

    python -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line per seed.  The benchmark's runs do not run it."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmark import common, serving
from benchmark.reference import kmeans as ref_kmeans


def serving_control(s: dict, seed: int, device) -> dict:
    """The control's readings on the slides a run of ``seed`` would check
    first: ``full`` slides of the largest size and ``other`` biopsies."""
    cfg, traffic = s["config"], s["traffic"]
    from_patches = traffic["entry"] == "slides"
    backbone = serving.backbone_weights(cfg, seed, device) if from_patches else None
    folds = serving.fold_weights(cfg, seed, device)
    b = cfg["backbone"]
    if from_patches:
        pool = serving.patch_pool(seed, traffic["pool"], b["patch_size"], device)
    else:
        inputs = serving.feature_pool(cfg, seed, traffic["pool"], device,
                                      traffic["pool_precision"])
    want = {True: traffic["check"]["full"], False: traffic["check"]["other"]}
    picked = []
    for n, off, _ in serving.schedule(traffic, seed, traffic["pool"]):
        big = n == traffic["cycle"]["full"]
        if want[big]:
            want[big] -= 1
            picked.append((n, off))
        if not any(want.values()):
            break
    out = {"feat_gap": 0.0, "kmeans_misfit": 0.0, "genes_gap": 0.0}
    rows = traffic["check"].get("rows", 0)
    k = cfg["kmeans"]["n_clusters"]
    for i, (n, lo) in enumerate(picked):
        if from_patches:
            x = serving.reference_features(cfg, backbone, pool[lo:lo + n], device, "fp8")
            pick = np.sort(serving.rng(seed, 1000 + i).choice(n, size=min(rows, n),
                                                              replace=False))
            ref = serving.reference_features(cfg, backbone, pool[lo + pick], device)
            out["feat_gap"] = max(out["feat_gap"], serving.feat_gap(x[pick], ref))
        else:
            x = torch.as_tensor(inputs[lo:lo + n], device=device)
        cf = ref_kmeans.fit_means(x, k, serving.gen(seed, 7 + i, device), mode="tf32")
        ctrl = serving.reference_genes(cfg, folds, cf, mode="fp8").cpu().numpy()[None]
        for key, v in serving.judge(cfg, folds, x, cf, ctrl).items():
            out[key] = max(out[key], v)
    if not from_patches:
        del out["feat_gap"]
    return out


def train_control(s: dict, seed: int, device) -> dict:
    """The readings of the TF32 reference, and of the f32 reference with half
    of each batch left out, against the f32 reference, on the batches and
    weights of a run of ``seed``: over its first steps from the seeded
    weights, and over the first steps of the second epoch from where the f32
    reference's first epoch ends (its parameters and moments), as a run
    follows set-up and the window, each number the larger of the two; and
    ``epoch_gap`` over the whole first epoch."""
    from sequoia_tpu_torch.data import dataset as ds
    from sequoia_tpu_torch.data import splits

    from benchmark import weights
    from benchmark.entries import train as entry
    from benchmark.reference import train as ref_train

    cfg, traffic = s["config"], s["traffic"]
    v, t = cfg["vis"], cfg["train"]
    k = traffic["check_steps"]
    feats, rna = entry.cohort(traffic, v["num_outputs"], v["input_dim"], seed, device)
    train_idx, _, _ = splits.patient_split(np.arange(len(feats)),
                                           random_state=seed % serving.SEED_MOD)
    loader = ds.BatchLoader(entry.MemoryCohort(feats, rna, train_idx), t["batch_size"],
                            shuffle=True, seed=seed % 2 ** 31)
    epoch0 = [(b.features, b.rna, b.valid) for b in loader]
    epoch1 = [(b.features, b.rna, b.valid) for b in loader][:k]
    shape = dict(serving.vis_shape(cfg), tokens=traffic["tokens"])
    params = weights.vis_fold(serving.gen(seed, 200, device), **shape)
    kw = dict(heads=v["nheads"], lr=t["lr"], betas=tuple(t["betas"]), eps=t["eps"],
              device=device)
    warm = ref_train.follow(params, epoch0, **kw)
    stretches = [(params, epoch0[:k], None), (warm["params"], epoch1, warm["moments"])]
    out = {"control": {}, "half_batch": {}}
    for start, batches, moments in stretches:
        ref = ref_train.follow(start, batches, moments=moments, **kw)
        half = halved(batches)
        g = ref["grad_norms"]
        keep = [x >= 1e-3 * float(np.median(g)) for x in g]
        for name, run in (("control", ref_train.follow(start, batches, mode="tf32",
                                                        moments=moments, **kw)),
                          ("half_batch", ref_train.follow(start, half, moments=moments, **kw))):
            loss_gap = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"]))
            r = {"loss_gap": loss_gap, "grad_gap": entry._gap(run["grad_norms"], g),
                 "update_gap": entry._gap(run["change_norms"], ref["change_norms"], keep)}
            for key, val in r.items():
                out[name][key] = max(out[name].get(key, 0.0), val)
    for name, batches, mode in (("control", epoch0, "tf32"),
                                ("half_batch", halved(epoch0), "float32")):
        out[name]["epoch_gap"] = entry.epoch_gap(
            ref_train.leaves(params),
            ref_train.leaves(ref_train.follow(params, batches, mode=mode, **kw)["params"]), warm)
    return out


def halved(batches: list) -> list:
    """Each batch with the second half of its rows masked out."""
    return [(f, r, np.where(np.arange(len(m)) < len(m) // 2, m, False)) for f, r, m in batches]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    s = common.spec(common.CHECKOUT / "BENCHMARK.json", args.workload)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        if s["traffic"]["entry"] == "train":
            r = train_control(s, seed, dev)
        else:
            r = {"control": serving_control(s, seed, dev)}
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
