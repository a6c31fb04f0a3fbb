"""Entry ``train``: one CV fold of ViS training through ``train.loop.train``
as ``train/cv.py`` calls it (AdamW at lr 1e-3, the fold's training and
validation loaders, phases train then val, no ``save_fn``) on a cohort of
cluster features held in host memory.

Set-up is the first epoch of that same call: it builds the model and the
optimizer and warms every shape.  The window opens at the end of that epoch
and closes at the end of the first epoch that ends past ``--seconds``; the
rate is the training slides of its epochs over its time, validation
included.  The check follows two stretches of ``check_steps`` steps: the
first steps of set-up, from the seeded weights, and the first steps of the
window, from the parameters and AdamW moments the program holds when it
opens."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import arith, common, serving, weights
from benchmark import trace as tr
from benchmark.reference import train as ref_train


class WindowClosed(Exception):
    """Raised from ``log_fn`` to end the training call with the window."""


class MemoryCohort:
    """Slides of (tokens, D) cluster features and their genes in host
    memory, with the reader interface ``data.dataset.BatchLoader`` takes."""

    def __init__(self, feats: np.ndarray, rna: np.ndarray, rows: np.ndarray):
        self.feats, self.rna, self.rows = feats, rna, rows
        self.num_genes = rna.shape[1]
        self.feature_dim = feats.shape[2]
        self.num_tokens = feats.shape[1]

    def __len__(self) -> int:
        return len(self.rows)

    def load_features(self, i: int) -> np.ndarray:
        return self.feats[self.rows[i]]

    def load_rna(self, i: int) -> np.ndarray:
        return self.rna[self.rows[i]]

    def meta(self, i: int) -> tuple[str, str]:
        return f"slide-{int(self.rows[i])}", "TCGA-SIM"


class Recording:
    """A loader whose first two passes (set-up's epoch and the window's
    first) each keep their first ``k`` batches."""

    def __init__(self, loader, k: int):
        self.loader, self.k, self.kept, self.passes = loader, k, ([], []), 0

    def __iter__(self):
        kept = self.kept[self.passes] if self.passes < len(self.kept) else None
        self.passes += 1
        for batch in self.loader:
            if kept is not None and len(kept) < self.k:
                kept.append((batch.features, batch.rna, batch.valid))
            yield batch


class Followed:
    """What the program did over ``k`` training steps from a snapshot of its
    parameters (and AdamW's moments, past the first step): the forward
    outputs, each leaf's first gradient as the optimizer holds or is handed
    it, and each leaf after the ``k`` steps.  Copies on the device, taken
    without a synchronise; their norms are read after the window."""

    def __init__(self, k: int, start: list, moments=None):
        self.k, self.start, self.moments = k, start, moments
        self.steps, self.preds, self.grads, self.end = 0, [], None, None


def cohort(traffic: dict, genes: int, dim: int, seed: int, device):
    """(slides, tokens, dim) f32 features and (slides, genes) f32 targets
    on the host, drawn on the device."""
    n, t, f = traffic["cohort"], traffic["tokens"], traffic["features"]
    g = serving.gen(seed, 6, device)
    feats = np.empty((n, t, dim), np.float32)
    means = torch.empty((n, dim), device=device)
    for s in range(0, n, 64):
        m = min(64, n - s)
        centre = torch.relu(f["centre_mean"] + f["slide_noise"]
                            * torch.randn((m, 1, dim), generator=g, device=device))
        x = torch.relu(centre + f["token_noise"]
                       * torch.randn((m, t, dim), generator=g, device=device))
        means[s:s + m] = x.mean(1)
        feats[s:s + m] = x.cpu().numpy()
    w = torch.randn((dim, genes), generator=g, device=device) * dim ** -0.5
    rna = (means - means.mean(0)) @ w
    rna = rna + traffic["targets"]["noise"] * torch.randn(rna.shape, generator=g, device=device)
    return feats, rna.cpu().numpy()


def run(ctx: dict) -> dict:
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.data import dataset as ds
    from sequoia_tpu_torch.data import splits
    from sequoia_tpu_torch.models import vis
    from sequoia_tpu_torch.train import cv, loop

    cfg, traffic, seed, dev = ctx["config"], ctx["traffic"], ctx["seed"], ctx["device"]
    v, t = cfg["vis"], cfg["train"]
    sync = lambda: common.sync(torch, dev)  # noqa: E731
    feats, rna = cohort(traffic, v["num_outputs"], v["input_dim"], seed, dev)
    train_idx, val_idx, _ = splits.patient_split(np.arange(len(feats)),
                                                 random_state=seed % serving.SEED_MOD)
    train_ds = MemoryCohort(feats, rna, train_idx)
    loaders = {"train": Recording(ds.BatchLoader(train_ds, t["batch_size"], shuffle=True,
                                                 seed=seed % 2 ** 31), traffic["check_steps"]),
               "val": ds.BatchLoader(MemoryCohort(feats, rna, val_idx), t["batch_size"],
                                     shuffle=False)}
    vcfg = vis.ViSConfig(num_outputs=v["num_outputs"], input_dim=v["input_dim"],
                         depth=v["depth"], nheads=v["nheads"], dim_f=v["dim_f"],
                         dim_s=v["dim_s"], dim_c=v["dim_c"], num_clusters=traffic["tokens"],
                         compute_dtype=None if t["compute_dtype"] == "float32"
                         else t["compute_dtype"])
    shape = dict(serving.vis_shape(cfg), tokens=traffic["tokens"])
    params = weights.vis_fold(serving.gen(seed, 200, dev), **shape)
    k = traffic["check_steps"]
    stages = [Followed(k, [p.detach().clone() for p in loop.tree_leaves(params)])]
    apply = cv._apply_fn("vis", vcfg)

    def following():
        f = stages[-1]
        return f if f.steps < f.k else None

    def apply_fn(p, x):
        out = apply(p, x)
        f = following()
        if f is not None and len(f.preds) <= f.steps and torch.is_grad_enabled():
            f.preds.append(out.detach().clone())
        return out

    state = {"t0": None, "prof": None, "steps": 0, "steps0": 0, "steps_traced": 0,
             "opt": None}

    def make_opt(p):
        opt = loop.make_adamw(p, lr=t["lr"], moment_dtype=None)
        leaves = opt.param_groups[0]["params"]
        b1 = opt.param_groups[0]["betas"][0]

        def before_step(o, *_):
            f = following()
            if f is not None and f.steps == 0 and f.moments is not None:
                f.grads = [q.grad.detach().clone() if q.grad is not None
                           else torch.zeros_like(q) for q in leaves]

        def after_step(o, *_):
            state["steps"] += 1
            f = following()
            if f is None:
                return
            f.steps += 1
            if f.steps == 1 and f.moments is None:
                f.grads = [o.state[q]["exp_avg"].detach() / (1 - b1) for q in leaves]
            if f.steps == f.k:
                f.end = [q.detach().clone() for q in leaves]
        opt.register_step_pre_hook(before_step)
        opt.register_step_post_hook(after_step)
        state["opt"] = opt
        if ctx.get("fault"):
            ctx["fault"](opt)
        return opt

    def snapshot():
        """The window's stretch starts from what the optimizer holds now."""
        opt = state["opt"]
        leaves = opt.param_groups[0]["params"]

        def moment(name):
            return [opt.state[q][name].detach().clone() if opt.state[q] else torch.zeros_like(q)
                    for q in leaves]
        moments = (moment("exp_avg"), moment("exp_avg_sq"),
                   int(float(opt.state[leaves[0]].get("step", 0))))
        stages.append(Followed(k, [q.detach().clone() for q in leaves], moments))

    marks = []
    window = common.Window(ctx["seconds"])

    def log_fn(epoch, phase, means):
        now = time.perf_counter()
        marks.append((epoch, phase, now, float(means["loss"])))
        if phase != "val":
            return
        if state["t0"] is None:
            sync()
            snapshot()
            state["open"] = (state["steps"], dict(_build.LAUNCHES))
            state["t0"] = window.open()
            if ctx["trace"]:
                state["prof"] = serving._start_profile(dev)
                state["steps0"] = state["steps"]
            return
        if state["prof"] is not None and epoch >= traffic["trace_epochs"]:
            state["done"] = serving._stop_profile(*state["prof"])
            state["steps_traced"] = state["steps"] - state["steps0"]
            state["prof"] = None
        if not window.due():
            raise WindowClosed

    closed = False
    try:
        loop.train(apply_fn, params, make_opt, loaders, num_epochs=10 ** 9,
                   patience=traffic["patience"], delta=0.5, save_on="loss", stop_on="loss",
                   phases=tuple(t["phases"]), log_fn=log_fn, verbose=False, device=dev)
    except WindowClosed:
        closed = True
    window_s = window.close() if closed else 0.0
    launches = common.launches_per(_build.LAUNCHES, *state.get("open", (0, {})),
                                   state["steps"])
    if state["prof"] is not None:
        state["done"] = serving._stop_profile(*state["prof"])
        state["steps_traced"] = state["steps"] - state["steps0"]
    if state.get("done") is not None:
        state["record"] = tr.reduce(tr.events_of(state["done"]))
    if not closed:
        print("training ended before the window closed", file=sys.stderr)
    device = common.device_info(torch, dev, ctx["chips"])
    in_window = [m for m in marks if m[2] > state["t0"]] if state["t0"] else []
    epochs = sum(1 for m in in_window if m[1] == "train")
    val_s = sum(m[2] - p[2] for p, m in zip(marks, marks[1:])
                if m[1] == "val" and p[1] == "train" and p[2] >= state["t0"])
    steps_per_epoch = -(-len(train_ds) // t["batch_size"])
    losses = [m[3] for m in in_window]
    bad = sum(1 for x in losses if not np.isfinite(x))
    state["opt"] = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = {"loss_gap": 1.0, "grad_gap": 1.0, "update_gap": 1.0, "epoch_gap": 1.0}
    read = []
    if len(stages) == 2:
        kw = dict(heads=v["nheads"], lr=t["lr"], betas=tuple(t["betas"]), eps=t["eps"],
                  device=dev)
        read = [train_readings(f, batches, ref_train.follow(
                    ref_train.rebuild(params, f.start), batches, moments=f.moments, **kw))
                for f, batches in zip(stages, loaders["train"].kept)]
        readings = {key: max(r[key] for r in read) for key in read[0]}
        first_epoch = ds.BatchLoader(train_ds, t["batch_size"], shuffle=True,
                                     seed=seed % 2 ** 31)
        whole = ref_train.follow(params, ((b.features, b.rna, b.valid) for b in first_epoch),
                                 **kw)
        readings["epoch_gap"] = epoch_gap(stages[0].start, stages[1].start, whole)
    step_flops = arith.vis_train_flops(batch=t["batch_size"], **shape)
    record = {"spans": {}, "items": {"steps_traced": state["steps_traced"]},
              "step_flops": step_flops, "trace": state.get("record"),
              "marks": {"window_s": window_s, "val_s": val_s}}
    e2e = {"train_slides_per_s": len(train_ds) * epochs / window_s if closed else None,
           "setup_s": (state["t0"] or time.perf_counter()) - ctx["t_start"]}
    return {"e2e": e2e, "record": record, "readings": readings,
            "attempted": epochs * steps_per_epoch, "failed": bad + (0 if closed else 1),
            "device": device,
            "notes": {"window_s": window_s, "epochs": epochs, "steps": state["steps"],
                      "last_val_loss": losses[-1] if losses else None,
                      "launches_per_step": launches,
                      "check_setup_then_window": read}}


def _gap(prog: list, ref: list, keep=None) -> float:
    """Worst leaf of ``|prog - ref|`` over the larger of the leaf's reference
    norm and the median leaf's."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = float(np.median([ref[i] for i in idx]))
    return max(abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx)


def epoch_gap(start: list, end: list, ref: dict) -> float:
    """The norm of each leaf's change over set-up's whole epoch, from the
    program's seeded ``start`` to the ``end`` the window opens on, against
    the reference's over the same batches (``ref``, from ``follow``),
    leaving out leaves whose reference gradient is under a thousandth of the
    median leaf's."""
    g = ref["grad_norms"]
    keep = [x >= 1e-3 * float(np.median(g)) for x in g]
    return _gap([ref_train.norm(e - s) for e, s in zip(end, start)], ref["change_norms"], keep)


def train_readings(f: Followed, batches: list, ref: dict) -> dict:
    """The readings of one followed stretch ``f``.  ``loss_gap``: each step's
    loss (the program's forward output against the batch's targets) against
    the reference's, as a share of it; ``grad_gap``: the first gradient's
    norm, leaf by leaf, as the program's optimizer holds it after the first
    step of set-up (``exp_avg / (1 - beta1)``) or is handed it at the first
    step of the window; ``update_gap``: the norm of each leaf's change over
    the stretch, leaving out leaves whose reference gradient is under a
    thousandth of the median leaf's."""
    loss = []
    for pred, (_, rna, valid) in zip(f.preds, batches):
        p = pred.double().cpu()
        loss.append(float(ref_train.masked_mse(p, torch.as_tensor(rna).double(),
                                               torch.as_tensor(valid))))
    if len(loss) < len(ref["losses"]) or f.grads is None or f.end is None:
        return {"loss_gap": 1.0, "grad_gap": 1.0, "update_gap": 1.0}
    grad_norms = [ref_train.norm(x) for x in f.grads]
    change_norms = [ref_train.norm(e - s) for e, s in zip(f.end, f.start)]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(loss, ref["losses"]))
    g = ref["grad_norms"]
    med = float(np.median(g))
    keep = [x >= 1e-3 * med for x in g]
    return {"loss_gap": loss_gap, "grad_gap": _gap(grad_norms, g),
            "update_gap": _gap(change_norms, ref["change_norms"], keep)}
