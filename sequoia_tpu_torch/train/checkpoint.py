"""Checkpoint interchange with the reference's torch formats.

Counterpart of ``sequoia_tpu/train/checkpoint.py``: the checkpoint readers
and writers (``:26-163``), the ViS and HE2RNA hub layouts (``:141-178``) and
the train-state resume (``:187-224``); Orbax's sharded states
(``save_orbax``/``load_orbax``, ``:227-247``) become
``torch.distributed.checkpoint`` (:func:`save_sharded`, :func:`load_sharded`).
The contracts:

* ViS/ViT: ``torch.save(model.state_dict(), 'model_best_{split}.pt')``,
  plain name -> tensor dicts.
* HE2RNA: ``torch.save(model, ...)``, a whole-module pickle.  Loading it
  without the reference class on the path goes through an unpickler shim
  that stands a bare ``nn.Module`` in for the missing class;
  :func:`load_torch_checkpoint` reads both forms and returns a flat
  ``{name: np.ndarray}`` state dict (with ``__ks__`` for a module that has
  a ``ks`` sweep).
* The HuggingFace hub layout (``PyTorchModelHubMixin``): a directory with
  ``config.json`` and ``model.safetensors`` or ``pytorch_model.bin``.  The
  port reads a local directory only; where the JAX function would download a
  repo id, this one raises.

``safetensors`` is imported only where a file needs it.
"""

from __future__ import annotations

import json
import os
import pickle
from collections import OrderedDict

import numpy as np
import torch


def _to_numpy_sd(obj) -> dict[str, np.ndarray]:
    """A state dict or a whole module -> ``{name: np.ndarray}``; a module's
    ``ks`` hyperparameter (which its state dict drops) is kept as
    ``__ks__``."""
    extra = {}
    if isinstance(obj, torch.nn.Module):
        if hasattr(obj, "ks"):
            try:
                extra["__ks__"] = np.asarray([int(k) for k in obj.ks])
            except (TypeError, ValueError):
                pass
        obj = obj.state_dict()
    out = dict(extra)
    for k, v in obj.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


class _PickleShimModule:
    """A pickle-module stand-in that hands ``torch.load`` a custom
    Unpickler."""

    __name__ = "sequoia_pickle_shim"

    def __init__(self, unpickler):
        self.Unpickler = unpickler
        self.load = pickle.load
        self.loads = pickle.loads


def _shimmed_torch_load(path: str):
    """``torch.load`` of a whole-module pickle whose classes are not
    importable: each missing class becomes a bare ``nn.Module`` subclass
    (unpickling bypasses ``__init__`` and restores the attribute tree, so
    ``state_dict()`` works)."""

    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (torch.nn.Module,), {})

    with open(path, "rb") as f:
        return torch.load(f, map_location="cpu", weights_only=False,
                          pickle_module=_PickleShimModule(Unpickler))


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """A ``.pt`` state dict or whole-module pickle -> numpy state dict."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        try:
            obj = torch.load(path, map_location="cpu", weights_only=False)
        except (ModuleNotFoundError, AttributeError):
            obj = _shimmed_torch_load(path)
    return _to_numpy_sd(obj)


def save_torch_state_dict(sd: dict[str, np.ndarray], path: str) -> None:
    """Write a torch-loadable ``.pt`` state dict (the reference's on-disk
    checkpoint contract)."""
    od = OrderedDict((k, torch.from_numpy(np.array(v, copy=True))) for k, v in sd.items())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(od, path)


def load_hf_vis_state_dict(path: str) -> dict[str, np.ndarray]:
    """State dict from a local ``PyTorchModelHubMixin`` directory with
    ``model.safetensors`` or ``pytorch_model.bin``.  A hub repo id raises:
    the port takes a local path and downloads nothing."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path!r} is not a local directory: load_hf_vis_state_dict takes a local "
            "path to a downloaded snapshot (config.json + model.safetensors or "
            "pytorch_model.bin); the port downloads nothing")
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        try:
            from safetensors.numpy import load_file
        except ImportError:
            raise RuntimeError(f"{st} needs the safetensors package, which is not "
                               "installed; write the fold as pytorch_model.bin instead") from None
        return dict(load_file(st))
    bin_ = os.path.join(path, "pytorch_model.bin")
    if not os.path.exists(bin_):
        raise FileNotFoundError(f"{path} has neither model.safetensors nor pytorch_model.bin "
                                "(sharded checkpoints are not supported)")
    return load_torch_checkpoint(bin_)


def _write_hf_dir(out_dir: str, config: dict, sd) -> None:
    """``PyTorchModelHubMixin`` layout: ``config.json`` (the model's
    constructor kwargs) and ``model.safetensors``, or ``pytorch_model.bin``
    where safetensors is not installed."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    try:
        from safetensors.numpy import save_file
    except ImportError:
        save_torch_state_dict(sd, os.path.join(out_dir, "pytorch_model.bin"))
        return
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              os.path.join(out_dir, "model.safetensors"))


class _Leaf:
    """A tensor's place in a train-state skeleton: the index of its npz
    entry."""

    def __init__(self, i: int):
        self.i = i


def _split_leaves(obj, leaves: list, path: str = ""):
    """(skeleton, leaves): ``obj`` (nested dicts, lists and tuples) with
    every tensor or array replaced by a :class:`_Leaf` and appended to
    ``leaves`` as ``(key path, tensor)``; other values (ints, floats,
    strings, the optimizer's ``param_groups``) stay in the skeleton."""
    if isinstance(obj, dict):
        return {k: _split_leaves(v, leaves, f"{path}/{k}") for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_split_leaves(v, leaves, f"{path}/{i}") for i, v in enumerate(obj))
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        leaves.append((path, torch.as_tensor(obj)))
        return _Leaf(len(leaves) - 1)
    return obj


def _join_leaves(obj, leaves: list):
    if isinstance(obj, _Leaf):
        return leaves[obj.i]
    if isinstance(obj, dict):
        return {k: _join_leaves(v, leaves) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_join_leaves(v, leaves) for v in obj)
    return obj


def save_train_state(path: str, params, opt_state, meta: dict) -> None:
    """Atomic save of a full training state: ``params`` (nested dicts of
    tensors), ``opt_state`` (an optimizer's ``state_dict()``) and ``meta``
    (the loop's counters).  Tensors go to npz leaves; the skeletons, each
    leaf's key path and dtype, and ``meta`` to a pickled blob.  A bf16 leaf
    (which numpy cannot hold) is stored as its ``uint16`` bits and viewed
    back on load, so bf16 AdamW moments come back bf16 and bit-equal."""
    leaves: list = []
    skel_p = _split_leaves(params, leaves, "params")
    skel_o = _split_leaves(opt_state, leaves, "opt")
    payload = {}
    for i, (_, t) in enumerate(leaves):
        t = t.detach().cpu()
        payload[f"l{i}"] = (t.view(torch.int16).numpy().view(np.uint16)
                            if t.dtype == torch.bfloat16 else t.numpy())
    blob = {"params": skel_p, "opt": skel_o, "meta": meta,
            "leaves": [(p, str(t.dtype).removeprefix("torch.")) for p, t in leaves]}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"  # one per writer: concurrent savers on a
    # shared filesystem must not interleave into one file
    with open(tmp, "wb") as f:
        np.savez(f, __blob__=np.frombuffer(pickle.dumps(blob), np.uint8), **payload)
    os.replace(tmp, path)


def load_train_state(path: str):
    """(params, opt_state, meta) saved by :func:`save_train_state`, every
    tensor on the CPU in its saved dtype."""
    with np.load(path, allow_pickle=False) as z:
        blob = pickle.loads(z["__blob__"].tobytes())
        leaves = []
        for i, (_, dtype) in enumerate(blob["leaves"]):
            a = z[f"l{i}"]
            leaves.append(torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                          if dtype == "bfloat16" else torch.from_numpy(a))
    return (_join_leaves(blob["params"], leaves), _join_leaves(blob["opt"], leaves),
            blob["meta"])


def save_hf_vis_layout(out_dir: str, cfg, params) -> None:
    """A ViS directory in the hub layout that the reference's
    ``ViS.from_pretrained(path)`` loads unchanged; the config keys are the
    reference ViS constructor's kwargs."""
    from sequoia_tpu_torch.models import convert

    _write_hf_dir(out_dir, {
        "num_outputs": cfg.num_outputs,
        "input_dim": cfg.input_dim,
        "depth": cfg.depth,
        "nheads": cfg.nheads,
        "dimensions_f": cfg.dim_f,
        "dimensions_s": cfg.dim_s,
        "dimensions_c": cfg.dim_c,
        "num_clusters": cfg.num_clusters,
    }, convert.vis_to_torch(cfg, params))


def save_hf_he2rna_layout(out_dir: str, cfg, params) -> None:
    """An HE2RNA directory in the hub layout (the reference's HE2RNA mixes in
    ``PyTorchModelHubMixin`` too, ``he2rna.py:42``).  ``nonlin`` and
    ``bias_init`` are left out: the defaults rebuild them and the trained
    bias already carries any init."""
    from sequoia_tpu_torch.models import convert

    _write_hf_dir(out_dir, {
        "input_dim": cfg.input_dim,
        "output_dim": cfg.output_dim,
        "layers": list(cfg.layers),
        "ks": list(cfg.ks),
        "dropout": cfg.dropout,
    }, convert.he2rna_to_torch(cfg, params))


def _flat(tree, prefix: str = "") -> dict:
    """``{"a.b.0": leaf}`` for a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _flat_specs(tree, specs, prefix: str = "") -> dict:
    """:func:`_flat` of ``specs`` along ``tree`` (a spec is a tuple, so the
    tree gives the structure)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_specs(v, specs[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat_specs(v, specs[i], f"{prefix}{i}.").items()}
    return {prefix[:-1]: specs}


def _unflat(tree, flat: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflat(v, flat, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflat(v, flat, f"{prefix}{i}.") for i, v in enumerate(tree))
    return flat[prefix[:-1]]


def _device_mesh(mesh):
    """The ``DeviceMesh`` of a ``multihost.GlobalMesh`` over the host
    backend (made once per mesh; every rank takes part)."""
    from torch.distributed.device_mesh import DeviceMesh

    dm = getattr(mesh, "_dcp_mesh", None)
    if dm is None:
        dm = mesh._dcp_mesh = DeviceMesh("cpu", torch.as_tensor(mesh.ranks),
                                         mesh_dim_names=("data", "model"))
    return dm


def _as_dtensors(flat: dict, specs: dict, mesh) -> dict:
    """Each rank's pieces as host ``DTensor``s: a mesh axis that a spec
    names splits that array axis (``Shard``), any other replicates."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm = _device_mesh(mesh)
    out = {}
    for k, t in flat.items():
        spec = tuple(specs[k])
        placements = [Shard(spec.index(ax)) if ax in spec else Replicate()
                      for ax in ("data", "model")]
        out[k] = DTensor.from_local(t.detach().cpu(), dm, placements, run_check=False)
    return out


def save_sharded(path: str, tree, mesh=None, specs=None) -> None:
    """A sharded train state through ``torch.distributed.checkpoint`` (the
    counterpart of the JAX package's ``save_orbax``): ``tree`` holds this
    rank's pieces of a ``multihost.GlobalMesh`` placed by ``specs`` (default
    ``sharding.param_pspecs``), or whole tensors without a mesh.  Every rank
    calls it and writes its own shard files; a replicated tensor is written
    once.  :func:`load_sharded` restores it on any mesh, or in one process."""
    import torch.distributed.checkpoint as dcp

    flat = _flat(tree)
    if mesh is not None:
        from sequoia_tpu_torch.parallel.sharding import param_pspecs

        flat = _as_dtensors(flat, _flat_specs(
            tree, specs if specs is not None else param_pspecs(tree)), mesh)
    else:
        flat = {k: v.detach().cpu() for k, v in flat.items()}
    dcp.save(flat, checkpoint_id=os.path.abspath(path))


def load_sharded(path: str, like=None, mesh=None, specs=None):
    """The tree :func:`save_sharded` wrote, whatever mesh wrote it: with
    ``mesh``, this rank's pieces shaped like ``like`` (its pieces, placed by
    ``specs``) on ``like``'s devices and dtypes; without one, whole tensors
    (the structure and dtypes of ``like``, or every saved tensor on the CPU
    under its flat key when ``like`` is None)."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if like is None:
        meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        flat = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                for k, m in meta.items() if hasattr(m, "size")}
        dcp.load(flat, checkpoint_id=path)
        return flat
    like_flat = _flat(like)
    if mesh is not None:
        from sequoia_tpu_torch.parallel.sharding import param_pspecs

        flat = _as_dtensors(like_flat, _flat_specs(
            like, specs if specs is not None else param_pspecs(like)), mesh)
        dcp.load(flat, checkpoint_id=path)
        got = {k: v.to_local() for k, v in flat.items()}
    else:
        got = {k: v.detach().cpu().clone() for k, v in like_flat.items()}
        dcp.load(got, checkpoint_id=path)
    return _unflat(like, {k: got[k].to(device=v.device, dtype=v.dtype)
                          for k, v in like_flat.items()})
