"""The first steps of one fold's ViS training as the reference runs them:
the masked mean squared error over the batch's valid rows and all genes,
autograd's gradients, and AdamW (torch's update with ``weight_decay`` 0)
written out, in f32 with TF32 off, or under ``mode``."""

from __future__ import annotations

import torch

from benchmark.reference import vis as ref_vis


def leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def rebuild(tree, leaves_: list):
    """``tree``'s structure with ``leaves_`` (in :func:`leaves`' order)."""
    return _rebuild(tree, iter(leaves_))


def norm(t: torch.Tensor) -> float:
    """A tensor's 2-norm, summed in float64 (an f32 sum over millions of
    elements drifts by 1e-5 on the CPU)."""
    return float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))


def masked_mse(pred, rna, valid):
    m = valid.to(pred.dtype)[:, None]
    return ((pred - rna).square() * m).sum() / (m.sum() * rna.shape[1])


def follow(params: dict, batches: list, *, heads: int, lr: float, betas, eps: float,
           device, mode: str = "float32", moments=None) -> dict:
    """Three (or ``len(batches)``) AdamW steps from ``params`` over
    ``batches`` of host ``(features, rna, valid)``: each step's loss, the
    norm of each leaf's first gradient, and the norm of each leaf's change
    after the last step; and the parameters and ``moments`` it ends with.
    ``moments``: ``(exp_avg, exp_avg_sq, steps)`` that AdamW holds after
    ``steps`` steps; fresh moments without."""
    start = [t.detach().float().clone() for t in leaves(params)]
    live = [t.clone().requires_grad_(True) for t in start]
    if moments is None:
        m1 = [torch.zeros_like(t) for t in start]
        m2 = [torch.zeros_like(t) for t in start]
        step0 = 0
    else:
        m1 = [t.detach().float().clone() for t in moments[0]]
        m2 = [t.detach().float().clone() for t in moments[1]]
        step0 = int(moments[2])
    b1, b2 = betas
    losses, first = [], None
    for step, (feats, rna, valid) in enumerate(batches, start=step0 + 1):
        tree = _rebuild(params, iter(live))
        x = torch.as_tensor(feats, device=device)
        y = torch.as_tensor(rna, device=device)
        v = torch.as_tensor(valid, device=device)
        loss = masked_mse(ref_vis.forward(tree, x, heads, mode), y, v)
        grads = torch.autograd.grad(loss, live)
        losses.append(float(loss.detach()))
        if first is None:
            first = [norm(g) for g in grads]
        with torch.no_grad():
            for p, g, a, s in zip(live, grads, m1, m2):
                a.mul_(b1).add_(g, alpha=1 - b1)
                s.mul_(b2).addcmul_(g, g, value=1 - b2)
                bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                p.sub_(lr * (a / bc1) / ((s / bc2).sqrt() + eps))
    change = [norm(p.detach() - s) for p, s in zip(live, start)]
    return {"losses": losses, "grad_norms": first, "change_norms": change,
            "params": rebuild(params, [p.detach() for p in live]),
            "moments": (m1, m2, step0 + len(losses))}
