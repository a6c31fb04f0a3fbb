"""The (data, model) layout: data parallelism over batch rows and gene-head
tensor parallelism over the head's G columns.

Counterpart of ``sequoia_tpu/parallel/sharding.py``.  ``data`` carries the
batch (slides in training, patches in extraction, windows in the spatial
stage); ``model`` carries the gene axis of the (D, G) output head, whose
weights and AdamW moments are the largest tensor family at the full
20,820-gene panel.  Everything else is replicated.

A spec is a tuple naming, per axis, the mesh axis it splits over or None
(JAX's ``PartitionSpec``; ``P()`` is replicated).  Two kinds of mesh take
the same functions:

* :class:`Mesh` (:func:`make_mesh`): an in-process (n_data, n_model) grid of
  ``torch.device`` objects that one process drives.  A placed value is a
  grid (a list of rows, each a list over ``model``) of per-device pieces;
  ``dp_images`` gives one piece per ``data`` row.  The grid may name one
  device more than once (``[cpu, cpu]``), as the JAX tests use virtual CPU
  devices.
* ``multihost.GlobalMesh``: one rank per device over ``torch.distributed``.
  A placed value is this rank's own piece, on its device.

Every split must be even: like JAX's ``device_put``, an axis that the mesh
does not divide raises.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from sequoia_tpu_torch.parallel.multihost import GlobalMesh, all_reduce, rank_device


def P(*axes) -> tuple:
    """A partition spec: the mesh axis each array axis splits over, or None."""
    return tuple(axes)


@dataclasses.dataclass(eq=False)
class Mesh:
    """An in-process (n_data, n_model) grid of devices."""
    devices: tuple

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """The device shards are gathered on."""
        return self.devices[0][0]

    def cells(self):
        """``(i, j, device)`` for every grid position, row-major."""
        return [(i, j, d) for i, row in enumerate(self.devices) for j, d in enumerate(row)]


def in_process(mesh, what: str) -> "Mesh":
    """``mesh`` when it is an in-process :class:`Mesh`; a TypeError naming
    ``what`` otherwise (under ``torch.distributed`` each rank runs its own
    ``what``)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{what} takes an in-process parallel.sharding.Mesh, got "
                        f"{type(mesh).__name__}; under torch.distributed each rank runs "
                        "its own")
    return mesh


def local_devices(device_type: str | None = None) -> list[torch.device]:
    """This process's devices: every CUDA device, or only the rank's own
    (``multihost.rank_device``) once the process is a rank of a
    ``torch.distributed`` group (one process per device); the CPU where
    there is no CUDA device (or ``device_type="cpu"``)."""
    if device_type != "cpu" and torch.cuda.is_available():
        if dist.is_initialized():
            return [rank_device()]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if device_type == "cuda":
        raise RuntimeError("no CUDA device is available")
    return [torch.device("cpu")]


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """The first ``n_data * n_model`` of ``devices`` (default: every CUDA
    device) as a row-major (n_data, n_model) grid."""
    devices = [torch.device(d) for d in (local_devices() if devices is None else devices)]
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"mesh data={n_data} model={n_model} needs {n_data * n_model} "
                         f"devices; {len(devices)} given")
    return Mesh(tuple(tuple(devices[i * n_model:(i + 1) * n_model]) for i in range(n_data)))


def shard_axis(t: torch.Tensor, axis: int, n: int, i: int) -> torch.Tensor:
    """Piece ``i`` of ``n`` equal pieces of ``t`` along ``axis``."""
    size = t.shape[axis]
    if size % n:
        raise ValueError(f"axis {axis} of size {size} not divisible by the mesh axis {n}")
    step = size // n
    return t.narrow(axis, i * step, step)


def _piece(t: torch.Tensor, spec: tuple, idx: dict, shape: dict) -> torch.Tensor:
    for ax, name in enumerate(spec):
        if name is not None:
            t = shard_axis(t, ax, shape[name], idx[name])
    return t


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _place(mesh, tree, specs):
    """``tree`` placed by ``specs`` (a matching tree of specs, or one spec
    for every leaf): this rank's piece, or the in-process grid of pieces."""
    same = isinstance(specs, tuple) and all(isinstance(a, (str, type(None))) for a in specs)

    def spec_tree():
        return _tree_map(lambda _: specs, tree) if same else specs

    if isinstance(mesh, GlobalMesh):
        idx = {"data": mesh.data_index, "model": mesh.model_index}
        return _tree_map(lambda t, s: _piece(torch.as_tensor(t), s, idx, mesh.shape)
                         .to(mesh.device, copy=True), tree, spec_tree())
    grid = [[None] * mesh.shape["model"] for _ in range(mesh.shape["data"])]
    for i, j, dev in mesh.cells():
        idx = {"data": i, "model": j}
        grid[i][j] = _tree_map(lambda t, s: _piece(torch.as_tensor(t), s, idx, mesh.shape)
                               .to(dev, copy=True), tree, spec_tree())
    return grid


def param_pspecs(params) -> dict:
    """Specs of a ViS/ViT parameter tree: the head's gene axis over
    ``model`` (``head_w`` (D, G), ``head_b`` (G,)), everything else
    replicated."""
    specs = _tree_map(lambda _: P(), params)
    if isinstance(params, dict) and "head_w" in params:
        specs["head_w"] = P(None, "model")
        specs["head_b"] = P("model")
    return specs


def shard_params(mesh, params):
    """``params`` placed by :func:`param_pspecs`."""
    return _place(mesh, params, param_pspecs(params))


def leaf_specs(params) -> list:
    """:func:`param_pspecs` in the leaf order an optimizer built on the tree
    indexes its state by (``train.loop.tree_leaves``)."""
    out: list = []

    def walk(p, s):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], s[k])
        elif isinstance(p, (list, tuple)):
            for a, b in zip(p, s):
                walk(a, b)
        else:
            out.append(s)

    walk(params, param_pspecs(params))
    return out


def opt_state_pspecs(opt_state: dict, params) -> dict:
    """Specs of a torch optimizer ``state_dict()`` over the leaves of
    ``params``: a moment shaped like its parameter (AdamW's ``exp_avg`` and
    ``exp_avg_sq``, in f32 or ``LowMemAdamW``'s dtype) takes the
    parameter's spec, so the gene head's moments split with the head; the
    step counts are replicated."""
    specs = leaf_specs(params)
    return {"state": {i: {k: (specs[i] if torch.is_tensor(v) and v.ndim else P())
                          for k, v in st.items()}
                      for i, st in opt_state["state"].items()}}


def shard_opt_state(mesh: GlobalMesh, opt_state: dict, params) -> dict:
    """A whole optimizer ``state_dict()`` cut to this rank's moments."""
    specs = opt_state_pspecs(opt_state, params)["state"]
    idx = {"data": mesh.data_index, "model": mesh.model_index}
    state = {i: {k: (_piece(v, specs[i][k], idx, mesh.shape).to(mesh.device, copy=True)
                     if torch.is_tensor(v) and v.ndim else v)
                 for k, v in st.items()}
             for i, st in opt_state["state"].items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


def gather_axis(mesh: GlobalMesh, t: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The whole tensor from every rank's ``model`` piece: each rank writes
    its piece into a zeroed buffer and the buffers are summed over the
    model group (gloo has no all-gather on CUDA tensors)."""
    if "model" not in spec or mesh.shape["model"] == 1:
        return t.detach().clone()
    ax = spec.index("model")
    n = mesh.shape["model"]
    shape = list(t.shape)
    shape[ax] *= n
    # bf16 pieces travel as f32 (exact: every element has one nonzero term)
    wide = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    full = torch.zeros(shape, dtype=wide, device=t.device)
    full.narrow(ax, mesh.model_index * t.shape[ax], t.shape[ax]).copy_(t.detach())
    return all_reduce(full, mesh.model_group).to(t.dtype)


def gather_params(mesh: GlobalMesh, params, specs=None):
    """The whole parameter tree from this rank's pieces (a collective over
    the model group: every rank calls it)."""
    specs = specs if specs is not None else param_pspecs(params)
    return _tree_map(lambda t, s: gather_axis(mesh, t, s), params, specs)


def gather_opt_state(mesh: GlobalMesh, opt_state: dict, params, specs=None) -> dict:
    """The whole optimizer ``state_dict()`` from this rank's (a collective)."""
    specs = leaf_specs(params) if specs is None else specs
    state = {i: {k: (gather_axis(mesh, v, specs[i]) if torch.is_tensor(v) and v.ndim else v)
                 for k, v in st.items()}
             for i, st in opt_state["state"].items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


def shard_batch_arrays(mesh, features, rna, valid):
    """features (B, T, D) and valid (B,) by rows over ``data``; rna (B, G)
    by rows over ``data`` and columns over ``model``, beside the head's
    output."""
    tree = {"features": features, "rna": rna, "valid": valid}
    out = _place(mesh, tree, {"features": P("data"), "rna": P("data", "model"),
                              "valid": P("data")})
    if isinstance(mesh, GlobalMesh):
        return out["features"], out["rna"], out["valid"]
    return [[(c["features"], c["rna"], c["valid"]) for c in row] for row in out]


def dp_images(mesh, images):
    """An image batch split by rows over ``data``: this rank's rows, or one
    piece per ``data`` row of an in-process mesh (on the row's first
    device).  The backbone mixes no examples, so no collective follows."""
    if isinstance(mesh, GlobalMesh):
        return _place(mesh, images, P("data"))
    n = mesh.shape["data"]
    return [shard_axis(torch.as_tensor(images), 0, n, i).to(mesh.devices[i][0],
                                                            non_blocking=True)
            for i in range(n)]
