"""Rank bodies for the port's multi-process tests (run through
``sequoia_tpu_torch.parallel.multihost.spawn_local``).  This module imports
torch, numpy and the port only, so a spawned rank starts quickly."""

import numpy as np
import torch


def _vis(cfg_kw):
    from sequoia_tpu_torch.models import vis

    cfg = vis.ViSConfig(**cfg_kw)
    return cfg, (lambda p, x: vis.apply(cfg, p, x)), (lambda p, x: vis.head_input(cfg, p, x))


def sharded_steps(cfg_kw, params_np, batches, n_model, moment_dtype=None, local_size=None,
                  device="cpu"):
    """AdamW steps of the ViS over this rank's piece of each global batch.
    Returns each step's metrics, the whole parameters and AdamW moments
    gathered after the last step, the bytes of this rank's head slice and
    of its moments, and the ranks of its model group."""
    from sequoia_tpu_torch.models import convert
    from sequoia_tpu_torch.parallel import multihost as mh
    from sequoia_tpu_torch.parallel import sharding as sh
    from sequoia_tpu_torch.train import loop

    mesh = mh.make_global_mesh(n_model=n_model, device=device, local_size=local_size)
    cfg, apply_fn, head_input_fn = _vis(cfg_kw)
    full = convert.vis_params_from_numpy(params_np)
    specs = sh.leaf_specs(full)
    params = loop.tree_map(lambda t: t.requires_grad_(True), sh.shard_params(mesh, full))
    opt = loop.make_adamw(params, lr=1e-3, moment_dtype=moment_dtype)
    step, eval_step = loop.make_sharded_step_fns(apply_fn, opt, mesh, head_input_fn)
    metrics = []
    for feats, rna, valid in batches:
        f, r, v = sh.shard_batch_arrays(mesh, torch.from_numpy(feats), torch.from_numpy(rna),
                                        torch.from_numpy(valid))
        metrics.append({k: float(x) for k, x in step(params, f, r, v).items()})
    _, ev = eval_step(params, f, r, v)
    state = opt.state_dict()
    moment = opt.state[params["head_w"]]["exp_avg"]
    whole = sh.gather_params(mesh, params)
    whole_opt = sh.gather_opt_state(mesh, state, params, specs)
    return {"metrics": metrics, "eval": {k: float(x) for k, x in ev.items()},
            "params": loop.tree_map(lambda t: t.detach().float().cpu().numpy(), whole),
            "moments": {i: st["exp_avg"].float().cpu().numpy()
                        for i, st in whole_opt["state"].items()},
            "head_bytes": params["head_w"].numel() * params["head_w"].element_size(),
            "moment_bytes": moment.numel() * moment.element_size(),
            "moment_dtype": str(moment.dtype),
            "model_group": [int(r) for r in mesh.ranks[mesh.data_index]]}


def single_steps(cfg_kw, params_np, batches, moment_dtype=None):
    """The same steps in one process, unsharded."""
    from sequoia_tpu_torch.models import convert
    from sequoia_tpu_torch.train import loop

    cfg, apply_fn, _ = _vis(cfg_kw)
    params = loop.tree_map(lambda t: t.requires_grad_(True),
                           convert.vis_params_from_numpy(params_np))
    opt = loop.make_adamw(params, lr=1e-3, moment_dtype=moment_dtype)
    step, eval_step = loop.make_step_fns(apply_fn, opt)
    metrics = []
    for feats, rna, valid in batches:
        args = (torch.from_numpy(feats), torch.from_numpy(rna), torch.from_numpy(valid))
        metrics.append({k: float(x) for k, x in step(params, *args).items()})
    _, ev = eval_step(params, *args)
    return {"metrics": metrics, "eval": {k: float(x) for k, x in ev.items()},
            "params": loop.tree_map(lambda t: t.detach().float().numpy(), params),
            "moments": {i: st["exp_avg"].float().numpy()
                        for i, st in opt.state_dict()["state"].items()}}


def mesh_refusal(n_model, local_size):
    """The error :func:`make_global_mesh` raises for this layout, or None."""
    from sequoia_tpu_torch.parallel import multihost as mh

    try:
        mh.make_global_mesh(n_model=n_model, device="cpu", local_size=local_size)
    except ValueError as e:
        return str(e)
    return None


def dcp_save(path, tree_np, n_model):
    """Save ``tree_np`` from this rank's (1, n_model) pieces."""
    from sequoia_tpu_torch.parallel import multihost as mh
    from sequoia_tpu_torch.parallel import sharding as sh
    from sequoia_tpu_torch.train import checkpoint

    mesh = mh.make_global_mesh(n_model=n_model, device="cpu")
    tree = {k: torch.from_numpy(v) for k, v in tree_np.items()}
    local = sh.shard_params(mesh, tree)
    checkpoint.save_sharded(path, local, mesh)
    return local["head_w"].shape


def dcp_load(path, like_np, n_model):
    """Load this rank's (1, n_model) pieces of ``like_np``'s tree."""
    from sequoia_tpu_torch.parallel import multihost as mh
    from sequoia_tpu_torch.parallel import sharding as sh
    from sequoia_tpu_torch.train import checkpoint

    mesh = mh.make_global_mesh(n_model=n_model, device="cpu")
    like = sh.shard_params(mesh, {k: torch.from_numpy(np.zeros_like(v))
                                  for k, v in like_np.items()})
    got = checkpoint.load_sharded(path, like=like, mesh=mesh)
    whole = sh.gather_params(mesh, got)
    return {k: v.numpy() for k, v in whole.items()}


def mesh_runs(cfg_kw, params_np, batches, runs, refuse=None):
    """:func:`sharded_steps` for each ``(n_model, moment_dtype, local_size)``
    of ``runs`` over this world (one world, several meshes of it), then
    :func:`mesh_refusal` of ``refuse`` (``(n_model, local_size)``) if given."""
    out = [sharded_steps(cfg_kw, params_np, batches, n_model, moment_dtype, local_size)
           for n_model, moment_dtype, local_size in runs]
    return out + ([mesh_refusal(*refuse)] if refuse else [])


def _loaded():
    import sys
    import time
    return sorted(m.split(".")[0] for m in sys.modules)[:0] + [
        m for m in ("jax", "sequoia_tpu", "pytest", "_pytest", "tests.test_torch_multihost")
        if m in sys.modules], time.time()


def train_resumed(df, feature_path, cfg_kw, params_np, n_model, state_path, num_epochs):
    """``loop.train(mesh=)`` of the ViS over ``df``'s store on this rank's
    (data, model) mesh, resuming from ``state_path`` when it exists; returns
    rank 0's history and final parameters (None on the other ranks)."""
    import functools

    from sequoia_tpu_torch.data import dataset as ds
    from sequoia_tpu_torch.models import convert
    from sequoia_tpu_torch.parallel import multihost as mh
    from sequoia_tpu_torch.train import loop

    mesh = mh.make_global_mesh(n_model=n_model, device="cpu")
    _, apply_fn, head_input_fn = _vis(cfg_kw)
    data = ds.FeatureDataset(df, feature_path)
    loaders = {"train": ds.BatchLoader(data, 4, shuffle=True, seed=0),
               "val": ds.BatchLoader(data, 4, shuffle=False)}
    res = loop.train(apply_fn, convert.vis_params_from_numpy(params_np),
                     functools.partial(loop.make_adamw, lr=1e-3), loaders,
                     num_epochs=num_epochs, verbose=False, state_path=state_path, mesh=mesh,
                     head_input_fn=head_input_fn, prefetch_depth=0)
    if mesh.rank:
        return None
    return res.history, loop.tree_map(lambda t: t.numpy(), res.final_params)
