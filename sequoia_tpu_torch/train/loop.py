"""Training and evaluation loops with the reference's selection logic.

Counterpart of ``sequoia_tpu/train/loop.py`` (reference ``src/vit.py:117-311``):

* MSE loss and AdamW; an epoch's metrics are the means of its per-batch
  values (loss, MAE, mean per-gene Pearson r; SMAPE too when evaluating);
* model selection and early stopping with ``save_on``/``stop_on`` in
  {``loss``, ``loss+corr``} and ``patience``/``delta`` as the reference has
  them: the patience-on-loss trip switches saving to best correlation while
  the loss stays within ``delta``;
* ``evaluate`` returns ``(preds, real, wsis, projs)`` over the loader and
  ``predict`` ``(preds, wsis, projs)``.

The step runs on the device in eager PyTorch: the forward of ``apply_fn``,
``backward`` and the optimizer's step.  Each step's metrics stay on the
device; they are read once per epoch phase (one host sync), where reading a
batch's would sync every step.  Padded batch rows go through the forward and
are masked out of the loss, as in JAX.

The optimizer: ``torch.optim.AdamW`` (betas (0.9, 0.999), eps 1e-8,
``amsgrad=False``, ``weight_decay=0.0`` passed explicitly: torch's default is
0.01) with ``foreach=True`` on every device, so the card and the CPU run one
algorithm.  It forms ``sqrt(v) / sqrt(bc2) + eps`` and scales by ``lr /
bc1`` where optax divides ``m / bc1 / (sqrt(v / bc2) + eps)``: the two agree
to f32 rounding.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from sequoia_tpu_torch.data.dataset import BatchLoader, prefetch
from sequoia_tpu_torch.ops import stats
from sequoia_tpu_torch.ops.nn import compute_dtype
from sequoia_tpu_torch.utils.device import resolve_device, tree_to
from sequoia_tpu_torch.utils.profiling import current_request, in_request, span

BETAS, EPS = (0.9, 0.999), 1e-8
TRAIN_METRICS = ("loss", "mae", "corr")
EVAL_METRICS = ("loss", "mae", "corr", "smape")


def tree_map(fn, tree):
    """``fn`` on every tensor of a parameter tree (dicts, lists, tuples)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree in a fixed order (dict order, depth
    first): the order an optimizer built on the tree indexes its state by."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy, never a view of the live tensor (on the CPU ``.cpu()``
    would return the tensor itself, which the optimizer keeps updating)."""
    return t.detach().to("cpu", copy=True)


def make_adamw(params, lr: float = 1e-3, weight_decay: float = 0.0,
               moment_dtype=None) -> torch.optim.Optimizer:
    """AdamW over ``params`` (a parameter tree or a list of tensors) with
    torch's defaults but ``weight_decay=0.0``.

    ``moment_dtype``: None or "float32" is the parity path,
    ``torch.optim.AdamW``.  Any other dtype (e.g. "bfloat16") selects
    :class:`LowMemAdamW`, which stores both moments in that dtype and does
    the update in f32 (about 29% less optimizer memory traffic in bf16;
    opt-in and not the reference's numerics)."""
    leaves = tree_leaves(params) if isinstance(params, dict) else list(params or ())
    if not leaves:
        raise ValueError("make_adamw needs the parameters it updates (a parameter tree or "
                         "a list of tensors); got none")
    dt = _dtype(moment_dtype)
    if dt == torch.float32:
        return torch.optim.AdamW(leaves, lr=lr, betas=BETAS, eps=EPS,
                                 weight_decay=weight_decay, amsgrad=False, foreach=True)
    return LowMemAdamW(leaves, lr=lr, betas=BETAS, eps=EPS, weight_decay=weight_decay,
                       moment_dtype=dt)


def make_adam(params, lr: float = 1e-3) -> torch.optim.Optimizer:
    """Adam, not AdamW, over ``params`` (a parameter tree or a list of
    tensors): betas (0.9, 0.999), eps 1e-8 and ``weight_decay=0`` passed
    explicitly, foreach on every device (the reference HE2RNA ``fit``;
    JAX ``make_adam`` is ``optax.adam`` with the same constants)."""
    leaves = tree_leaves(params) if isinstance(params, dict) else list(params or ())
    if not leaves:
        raise ValueError("make_adam needs the parameters it updates; got none")
    return torch.optim.Adam(leaves, lr=lr, betas=BETAS, eps=EPS, weight_decay=0,
                            amsgrad=False, foreach=True)


def _dtype(name) -> torch.dtype:
    if name is None:
        return torch.float32
    dt = name if isinstance(name, torch.dtype) else getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"moment_dtype must be a floating dtype, got {name!r}")
    return dt


class LowMemAdamW(torch.optim.Optimizer):
    """AdamW with both moments stored in ``moment_dtype`` and the update done
    in f32 (the JAX package's ``_adamw_low_mem``): ``p -= lr * (m_hat /
    (sqrt(v_hat) + eps) + wd * p)`` with the bias corrections ``1 - b**t``
    in f32.  At ``moment_dtype=float32`` it follows ``torch.optim.AdamW`` to
    f32 rounding.

    ``load_state_dict`` keeps the moments' dtype: the base class casts a
    state tensor to its parameter's dtype, which would widen bf16 moments to
    f32 (exactly, so casting back restores the saved bits)."""

    def __init__(self, params, lr=1e-3, betas=BETAS, eps=EPS, weight_decay=0.0,
                 moment_dtype=torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.moment_dtype = moment_dtype

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            (b1, b2), lr, eps, wd = group["betas"], group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.moment_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=self.moment_dtype)
                st["step"] += 1
                bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** st["step"])
                bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** st["step"])
                g = p.grad.float()
                m = st["exp_avg"].float().mul_(b1).add_(g, alpha=1 - b1)
                v = st["exp_avg_sq"].float().mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
                if wd:
                    upd.add_(p.float(), alpha=wd)
                p.add_(upd.to(p.dtype), alpha=-lr)
                st["exp_avg"].copy_(m)
                st["exp_avg_sq"].copy_(v)
        return loss

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    st[k] = st[k].to(self.moment_dtype)


def make_eval_step(apply_fn: Callable):
    """``eval_step(params, feats, rna, valid) -> (pred, metrics)``, metrics
    as 0-d tensors on the device; the span ``train.eval_step``."""

    @torch.no_grad()
    def eval_step(params, feats, rna, valid):
        with span("train.eval_step"):
            pred = apply_fn(params, feats)
            return pred, {"loss": stats.masked_mse(pred, rna, valid),
                          "mae": stats.masked_mae(pred, rna, valid),
                          "corr": stats.mean_correlation(pred, rna, valid),
                          "smape": stats.masked_smape(pred, rna, valid)}

    return eval_step


def make_step_fns(apply_fn: Callable, optimizer: torch.optim.Optimizer):
    """(train_step, eval_step) for a ``pred = apply_fn(params, x)`` model
    (ViS, ViT).  ``train_step(params, feats, rna, valid) -> metrics``: the
    masked MSE's backward and one step of ``optimizer``, which must hold the
    leaves of ``params`` (it updates them in place); the metrics are those
    of the forward before the update, on the device.  The span
    ``train.step`` holds ``train.forward``, ``train.backward`` and
    ``train.optimizer``."""

    def train_step(params, feats, rna, valid):
        with span("train.step"):
            with span("train.forward"):
                optimizer.zero_grad(set_to_none=True)
                pred = apply_fn(params, feats)
                loss = stats.masked_mse(pred, rna, valid)
                with torch.no_grad():
                    out = pred.detach()
                    metrics = {"loss": loss.detach(), "mae": stats.masked_mae(out, rna, valid),
                               "corr": stats.mean_correlation(out, rna, valid)}
            with span("train.backward"):
                loss.backward()
            with span("train.optimizer"):
                optimizer.step()
        return metrics

    return train_step, make_eval_step(apply_fn)


@dataclasses.dataclass
class TrainResult:
    params: dict           # the best-checkpoint params (what model_best_{i}.pt holds)
    history: list[dict]
    best_epoch: int
    final_params: dict | None = None  # the last epoch's params: the reference's
    # ``train`` returns the live module and ``main.py:193`` evaluates it


def _mesh_metrics(pred, rna, valid, mesh, keys, s1=None) -> dict:
    """``keys`` of ``stats`` over the whole batch from this rank's (rows,
    genes) piece: every rank returns the same values.

    The sums behind each metric are reduced, never the metrics: the
    squared- and absolute-error sums over every rank, the valid-row count
    over ``data``.  ``mean_correlation`` keeps ``stats``' two-pass form: the
    per-gene means over ``data``, then the centred sums over ``data``, r per
    local gene, and the r sum and kept-gene count over ``model`` (a one-pass
    sum of squares cancels in f32).  ``s1``: the first pass's reduced
    ``[n_valid, column sums of pred, of rna]`` when the caller has it."""
    from sequoia_tpu_torch.parallel.multihost import all_reduce

    pred, target = pred.detach().float(), rna.float()
    m = valid[:, None].to(torch.float32)
    g = target.shape[1]
    if s1 is None:
        s1 = _first_pass(pred, target, valid, mesh)
    n = s1[0].clamp(min=1)
    g_total = g * mesh.shape["model"]
    diff = pred - target
    sums = [(diff.square() * m).sum(), (diff.abs() * m).sum()]
    if "smape" in keys:
        den = target.abs() + pred.abs()
        pos = den > 0
        ratio = torch.where(pos, 2.0 * diff.abs() / torch.where(pos, den, torch.ones_like(den)),
                            torch.zeros_like(den))
        sums.append((ratio * m).sum())
    sums = all_reduce(torch.stack(sums))
    dp = (pred - s1[1:1 + g] / n) * m
    dt = (target - s1[1 + g:] / n) * m
    s2 = all_reduce(torch.cat([(dp * dt).sum(0), (dp * dp).sum(0), (dt * dt).sum(0)]),
                    mesh.data_group)
    cov, vp, vt = s2[:g], s2[g:2 * g], s2[2 * g:]
    r = cov / torch.sqrt(vp * vt)
    ok = (vt > 0) & ~torch.isnan(r)
    s3 = all_reduce(torch.stack([torch.where(ok, r, torch.zeros_like(r)).sum(),
                                 ok.sum().to(torch.float32)]), mesh.model_group)
    corr = torch.where(s3[1] > 0, s3[0] / s3[1].clamp(min=1),
                       torch.full_like(s3[0], float("nan")))
    out = {"loss": sums[0] / (n * g_total), "mae": sums[1] / (n * g_total), "corr": corr}
    if "smape" in keys:
        out["smape"] = 100.0 / n * sums[2]
    return {k: out[k] for k in keys}


def _first_pass(pred, target, valid, mesh) -> torch.Tensor:
    """``[n_valid, per-gene column sums of pred, of target]`` over the data
    group (the rows of every rank with this rank's genes)."""
    from sequoia_tpu_torch.parallel.multihost import all_reduce

    m = valid[:, None].to(torch.float32)
    return all_reduce(torch.cat([valid.sum().to(torch.float32).reshape(1),
                                 (pred.detach().float() * m).sum(0),
                                 (target.float() * m).sum(0)]), mesh.data_group)


class _ModelSum(torch.autograd.Function):
    """The identity going forward; going backward, the cotangent summed
    over ``group``.  On the gene head's ``(B, D)`` input it gives each rank
    of a ``model`` group the trunk gradient of every gene slice, not only
    its own."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from sequoia_tpu_torch.parallel.multihost import all_reduce

        return all_reduce(g.contiguous().clone(), ctx.group), None


def _reduce_grads(leaves: list, mesh) -> None:
    """Sum every gradient over the ``data`` group, in one all-reduce.

    After :class:`_ModelSum` a rank's gradients cover its own rows: the
    replicated tensors' for every gene, the head slice's for its genes.
    The ranks of its ``data`` group hold the other rows, so their sum is
    the whole batch's gradient.  The loss is a global sum over a global
    count, so nothing is rescaled."""
    from sequoia_tpu_torch.parallel.multihost import all_reduce

    grads = [p.grad for p in leaves if p.grad is not None]
    flat = all_reduce(torch.cat([g.reshape(-1).float() for g in grads]), mesh.data_group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def make_sharded_step_fns(apply_fn: Callable, optimizer: torch.optim.Optimizer, mesh,
                          head_input_fn: Callable | None = None):
    """(train_step, eval_step) of :func:`make_step_fns` for one rank of a
    ``multihost.GlobalMesh``: ``params`` hold the rank's gene-head slice,
    the batch arrays its rows (and rna its genes).

    ``head_input_fn(params, x)``: the model up to its gene head
    (``vis.head_input``), needed where the head is split (``model`` > 1).
    The step then routes its ``(B, D)`` output through :class:`_ModelSum`
    over the ``model`` group and applies the local ``head_w``/``head_b``.

    The loss is ``stats.masked_mse`` of the whole batch, sum / (n_valid *
    G): this rank's squared-error sum over the reduced count and the full
    gene count, so its backward gives this rank's share of every gradient,
    summed by :func:`_reduce_grads`."""
    from sequoia_tpu_torch.ops.nn import linear

    if mesh.shape["model"] > 1 and head_input_fn is None:
        raise ValueError("a model axis > 1 splits the gene head: pass head_input_fn, the "
                         "model up to its head (e.g. vis.head_input)")

    def forward(params, feats):
        if mesh.shape["model"] == 1:
            return apply_fn(params, feats)
        x = _ModelSum.apply(head_input_fn(params, feats), mesh.model_group)
        return linear(x, params["head_w"], params["head_b"])

    def train_step(params, feats, rna, valid):
        optimizer.zero_grad(set_to_none=True)
        pred = forward(params, feats)
        s1 = _first_pass(pred, rna, valid, mesh)
        m = valid[:, None].to(torch.float32)
        g_total = rna.shape[1] * mesh.shape["model"]
        sq = ((pred.float() - rna.float()).square() * m).sum()
        (sq / (s1[0].clamp(min=1) * g_total)).backward()
        _reduce_grads(tree_leaves(params), mesh)
        with torch.no_grad():
            metrics = _mesh_metrics(pred, rna, valid, mesh, TRAIN_METRICS, s1=s1)
        optimizer.step()
        return metrics

    @torch.no_grad()
    def eval_step(params, feats, rna, valid):
        pred = apply_fn(params, feats)
        return pred, _mesh_metrics(pred, rna, valid, mesh, EVAL_METRICS)

    return train_step, eval_step


def _uploader(dev: torch.device, feat_dtype: torch.dtype | None, mesh=None):
    """batch -> (feats, rna, valid) on ``dev``, or None for an all-pad batch.
    Features are cast to ``feat_dtype`` on the host first; on CUDA the
    arrays go through pinned memory with non-blocking copies.  Under a
    ``mesh`` the arrays are cut on the host to this rank's rows, and rna to
    its genes (``sharding.shard_batch_arrays``'s layout)."""
    pin = dev.type == "cuda"

    def up(t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.pin_memory().to(dev, non_blocking=True) if pin else t.to(dev)

    def to_device(batch):
        if batch.n_valid == 0:
            return None
        feats, rna, valid = (torch.from_numpy(np.asarray(a))
                             for a in (batch.features, batch.rna, batch.valid))
        if mesh is not None:
            from sequoia_tpu_torch.parallel.sharding import shard_axis

            nd, di = mesh.shape["data"], mesh.data_index
            feats, valid = shard_axis(feats, 0, nd, di), shard_axis(valid, 0, nd, di)
            rna = shard_axis(shard_axis(rna, 0, nd, di), 1, mesh.shape["model"],
                             mesh.model_index)
        if feat_dtype is not None and feats.dtype != feat_dtype:
            feats = feats.to(feat_dtype)
        return up(feats), up(rna), up(valid)

    return to_device


def _phase_means(rows: list, keys) -> dict:
    """The epoch phase's means of the per-batch metrics: one host read of
    all of them (the span ``train.readback``)."""
    if not rows:
        return {k: np.nan for k in keys}
    with span("train.readback"):
        vals = torch.stack(rows).cpu().numpy()  # (batches, metrics) f32
    return {k: float(np.mean(vals[:, j])) for j, k in enumerate(keys)}


def train(apply_fn, params, optimizer, loaders: dict[str, BatchLoader], *,
          num_epochs: int = 200, patience: int = 20, delta: float = 0.5,
          save_on: str = "loss", stop_on: str = "loss",
          phases=("train", "val"), save_fn: Callable | None = None,
          log_fn: Callable | None = None, verbose: bool = True,
          state_path: str | None = None, prefetch_depth: int = 2, mesh=None,
          head_input_fn: Callable | None = None, h2d_dtype: str | None = None,
          device=None) -> TrainResult:
    """The reference ``vit.train`` over eager steps on ``device`` (cuda
    unless asked otherwise; raises without CUDA).

    ``optimizer``: a callable that builds the optimizer over the parameter
    tree the loop trains, e.g. ``functools.partial(make_adamw, lr=1e-3)``
    (the loop copies ``params`` to the device and trains the copy).

    ``save_fn(params)`` is called wherever the reference writes
    ``model_best_{split}.pt``, with a host copy; ``TrainResult.params`` are
    the last saved (best) parameters, ``final_params`` the last epoch's, both
    on the CPU.

    ``state_path``: full resume.  The params, the best snapshot, the
    optimizer's state and the early-stop counters are saved after each
    epoch's stop decision and restored on restart; a fold that had stopped
    trains no further.

    ``h2d_dtype``: cast the feature batch to this dtype on the host (on the
    prefetch thread) before the upload.  Pass the model's ``compute_dtype``:
    ViS and ViT cast their input to it first, both casts round to nearest
    even, so the trajectory is bit-identical at half the upload in bf16.

    With neither ``save_fn`` nor ``state_path`` the best snapshot stays on
    the device (the previous one released first, a host copy taken if the
    device copy cannot be allocated).

    ``mesh``: a ``parallel.multihost.GlobalMesh``; every rank of it calls
    ``train`` with the same arguments.  Each rank trains its gene-head
    slice (``sharding.param_pspecs``; its AdamW moments are shaped like
    it) and a replica of the rest, on its batch rows and their targets'
    genes, through :func:`make_sharded_step_fns`; the batch size must
    divide by the ``data`` axis.  ``head_input_fn``: the model up to its
    gene head, needed where ``model`` > 1 (:func:`make_sharded_step_fns`).
    Every rank reads the same metrics and
    takes the same early-stop decisions.  The best and final parameters
    are gathered whole on every rank; ``save_fn``, ``log_fn``, the prints
    and the resume file are rank 0's, and the resume state is saved whole
    and cut to each rank's slice on load (the file does not depend on the
    mesh).

    The JAX loop's per-phase "step has compiled" gate on the prefetch
    thread has no counterpart: it kept uploads from overlapping an XLA
    compile, and eager PyTorch compiles nothing."""
    from sequoia_tpu_torch.train import checkpoint as ckpt_io

    lead = True
    if mesh is not None:
        from sequoia_tpu_torch.parallel import multihost
        from sequoia_tpu_torch.parallel import sharding as sh

        if not isinstance(mesh, multihost.GlobalMesh):
            raise TypeError("train(mesh=) takes a multihost.GlobalMesh (one rank per "
                            f"device), got {type(mesh).__name__}")
        if mesh.shape["model"] > 1 and not (isinstance(params, dict) and "head_w" in params):
            raise ValueError("a model axis > 1 splits the gene head; these params have no "
                             "head_w")
        dev = mesh.device
        lead = mesh.rank == 0
        specs = sh.leaf_specs(params)
        params = tree_map(lambda t: t.requires_grad_(True), sh.shard_params(mesh, params))
        opt = optimizer(params)
        train_step, eval_step = make_sharded_step_fns(apply_fn, opt, mesh, head_input_fn)

        def whole(p):  # a collective: every rank calls it
            return tree_map(_host, sh.gather_params(mesh, p))
    else:
        dev = resolve_device(device)
        params = tree_map(lambda t: t.detach().to(dev, copy=True).requires_grad_(True), params)
        opt = optimizer(params)
        train_step, eval_step = make_step_fns(apply_fn, opt)
    verbose = verbose and lead
    log_fn = log_fn if lead else None

    best_params = None
    best_loss = np.inf
    best_score = 0.0
    best_epoch = -1
    epoch_since_best = 0
    epoch_since_best_score = 0
    epoch_since_ok_loss = 0
    early_stop_on_loss_triggered = 0
    history: list[dict] = []
    start_epoch = 0

    if state_path and os.path.exists(state_path):
        packed, opt_state, meta = ckpt_io.load_train_state(state_path)
        if mesh is not None:  # saved whole: cut to this rank's slices
            opt_state = sh.shard_opt_state(mesh, opt_state, packed["params"])
            packed["params"] = sh.shard_params(mesh, packed["params"])
        with torch.no_grad():
            for dst, src in zip(tree_leaves(params), tree_leaves(packed["params"]), strict=True):
                dst.copy_(src)
        best_params = packed["best"]
        opt.load_state_dict(opt_state)
        (start_epoch, best_loss, best_score, best_epoch, epoch_since_best,
         epoch_since_best_score, epoch_since_ok_loss, early_stop_on_loss_triggered) = (
            meta["epoch"] + 1, meta["best_loss"], meta["best_score"], meta["best_epoch"],
            meta["epoch_since_best"], meta["epoch_since_best_score"],
            meta["epoch_since_ok_loss"], meta["early_stop_on_loss_triggered"])
        history = meta.get("history", [])
        if meta.get("stopped"):
            start_epoch = num_epochs  # the == patience trip point is behind us
        if verbose:
            print(f"resumed training state from {state_path} at epoch {start_epoch}")

    def save(p, epoch):
        with span("train.snapshot"):
            _save(p, epoch)

    def _save(p, epoch):
        nonlocal best_params, best_epoch
        if mesh is not None:
            best_params = whole(p)
            if save_fn is not None and lead:
                save_fn(best_params)
        elif save_fn is None and state_path is None:
            # nothing reads the snapshot before training ends: keep it on the
            # device, the old one released first so the extra memory stays
            # one param set; a host copy where the device copy cannot be had
            best_params = None
            try:
                best_params = tree_map(lambda t: t.detach().clone(), p)
            except torch.cuda.OutOfMemoryError:
                best_params = tree_map(_host, p)
        else:
            best_params = tree_map(_host, p)
            if save_fn is not None:
                save_fn(best_params)
        best_epoch = epoch

    to_device = _uploader(dev, compute_dtype(h2d_dtype) if h2d_dtype else None, mesh)

    def upload(batch):
        """``(request, uploaded batch)``: the span ``train.upload``, on the
        reader thread a request of its own, which the batch's step keeps."""
        with span("train.upload"):
            return current_request(), to_device(batch)

    for epoch in range(start_epoch, num_epochs):
        epoch_metrics: dict[str, dict[str, float]] = {}
        for phase in phases:
            rows: list = []
            keys = TRAIN_METRICS if phase == "train" else EVAL_METRICS
            # the reader thread uploads batch i+1 while batch i steps
            batches = (prefetch(loaders[phase], depth=prefetch_depth, transform=upload)
                       if prefetch_depth else map(upload, loaders[phase]))
            try:
                while True:
                    with span("train.batch_wait"):
                        got = next(batches, None)
                    if got is None:
                        break
                    request, item = got
                    if item is None:
                        continue
                    with in_request(request):
                        if phase == "train":
                            m = train_step(params, *item)
                        else:
                            _, m = eval_step(params, *item)
                    rows.append(torch.stack([m[k] for k in keys]))
            finally:
                # an exception mid-epoch must not strand the reader thread
                if prefetch_depth:
                    batches.close()
            means = _phase_means(rows, keys)
            epoch_metrics[phase] = means
            if log_fn:
                log_fn(epoch, phase, means)
            if verbose:
                print(f"Epoch {epoch}: {phase} loss {means['loss']:.6f} "
                      f"mae {means['mae']:.6f} corr {means['corr']:.4f}")

            if (phase == "val") or (len(phases) == 1):
                losses = means["loss"]
                scores = means["corr"]

                if early_stop_on_loss_triggered == 1:
                    if losses < (best_loss + delta):
                        epoch_since_ok_loss = 0
                    else:
                        epoch_since_ok_loss += 1

                if losses < best_loss:
                    best_loss = losses
                    epoch_since_best = 0
                    if save_on == "loss":
                        save(params, epoch)
                    elif save_on == "loss+corr" and early_stop_on_loss_triggered == 0:
                        save(params, epoch)
                else:
                    epoch_since_best += 1

                if scores > best_score:
                    best_score = scores
                    epoch_since_best_score = 0
                    if save_on == "loss+corr" and early_stop_on_loss_triggered == 1:
                        save(params, epoch)
                        if verbose:
                            print(f"Saved model on loss+corr at epoch {epoch}")
                else:
                    epoch_since_best_score += 1

        history.append(epoch_metrics)

        # the reference's == comparisons, kept (vit.py:229-242)
        stop_now = False
        if epoch_since_best == patience:
            early_stop_on_loss_triggered = 1
            if stop_on == "loss":
                if verbose:
                    print(f"Early stopping at epoch {epoch}!")
                stop_now = True

        if not stop_now and stop_on == "loss+corr":
            if early_stop_on_loss_triggered == 1 and epoch_since_best_score == patience:
                if verbose:
                    print(f"Early stopping at epoch {epoch}: neither loss nor score improving")
                stop_now = True
            elif early_stop_on_loss_triggered == 1 and epoch_since_ok_loss == patience:
                if verbose:
                    print(f"Early stopping at epoch {epoch}: loss left the {delta} band "
                          "around the best loss")
                stop_now = True

        # saved AFTER the stop decision: a resumed run sees the flags as set
        if state_path:
            state_params, state_opt = params, opt.state_dict()
            if mesh is not None:  # whole, so any mesh can resume it
                state_params = whole(params)
                state_opt = sh.gather_opt_state(mesh, state_opt, params, specs)
        if state_path and lead:
            ckpt_io.save_train_state(
                state_path, {"params": state_params, "best": best_params}, state_opt,
                {"epoch": epoch, "best_loss": float(best_loss),
                 "best_score": float(best_score), "best_epoch": best_epoch,
                 "epoch_since_best": epoch_since_best,
                 "epoch_since_best_score": epoch_since_best_score,
                 "epoch_since_ok_loss": epoch_since_ok_loss,
                 "early_stop_on_loss_triggered": early_stop_on_loss_triggered,
                 "stopped": int(stop_now), "history": history})

        if state_path and mesh is not None:
            multihost.barrier(mesh)  # no rank reads the file before rank 0 wrote it

        if stop_now:
            break

    final_params = whole(params) if mesh is not None else tree_map(_host, params)
    if best_epoch < 0:  # never saved (e.g. 0 epochs): the current params
        best_params = final_params
    else:  # a device snapshot comes down once, here
        best_params = tree_map(lambda t: t.detach().cpu(), best_params)
    return TrainResult(params=best_params, history=history, best_epoch=best_epoch,
                       final_params=final_params)


def _batch_to(batch, dev):
    return tuple(torch.from_numpy(a).to(dev) for a in (batch.features, batch.rna, batch.valid))


def evaluate(apply_fn, params, loader: BatchLoader, *, verbose: bool = True,
             log_fn: Callable | None = None, suffix: str = "", device=None):
    """The reference ``vit.evaluate``: ``(preds, real, wsis, projs)``, numpy,
    over the loader's valid rows."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    eval_step = make_eval_step(apply_fn)
    preds, real, wsis, projs, rows = [], [], [], [], []
    for batch in loader:
        if batch.n_valid == 0:
            continue
        pred, m = eval_step(params, *_batch_to(batch, dev))
        preds.append(pred.float().cpu().numpy()[batch.valid])
        real.append(batch.rna[batch.valid])
        wsis.extend(w for w, v in zip(batch.wsi, batch.valid) if v)
        projs.extend(p for p, v in zip(batch.project, batch.valid) if v)
        rows.append(torch.stack([m[k] for k in EVAL_METRICS]))
    means = _phase_means(rows, EVAL_METRICS) if rows else {}
    if log_fn and means:
        log_fn(0, "test" + suffix, means)
    if verbose and means:
        print(f"Test loss: {means['loss']:.6f}  MAE: {means['mae']:.6f}  "
              f"SMAPE: {means['smape']:.4f}")
    preds = np.concatenate(preds, axis=0) if preds else np.zeros((0, 0))
    real = np.concatenate(real, axis=0) if real else np.zeros((0, 0))
    return preds, real, np.asarray(wsis), np.asarray(projs)


@torch.no_grad()
def predict(apply_fn, params, loader: BatchLoader, *, device=None):
    """The reference ``vit.predict``: label-free batched inference ->
    ``(preds, wsis, projs)``."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    preds, wsis, projs = [], [], []
    for batch in loader:
        if batch.n_valid == 0:
            continue
        x = torch.from_numpy(batch.features).to(dev)
        preds.append(apply_fn(params, x).float().cpu().numpy()[batch.valid])
        wsis.extend(w for w, v in zip(batch.wsi, batch.valid) if v)
        projs.extend(p for p, v in zip(batch.project, batch.valid) if v)
    preds = np.concatenate(preds, axis=0) if preds else np.zeros((0, 0))
    return preds, np.asarray(wsis), np.asarray(projs)
