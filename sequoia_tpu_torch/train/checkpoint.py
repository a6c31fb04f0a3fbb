"""Checkpoint interchange with the reference's torch formats.

Counterpart of ``sequoia_tpu/train/checkpoint.py:26-178`` (the checkpoint
readers and writers; train-state resume and Orbax are not ported yet,
ROADMAP.md).  The contracts:

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
