"""Multi-process and multi-host work over ``torch.distributed``: the fleet
data plane and the global (data, model) mesh of ranks.

Counterpart of ``sequoia_tpu/parallel/multihost.py``.  The JAX package runs
one controller per host, each driving that host's chips; the port runs one
process per device (a *rank*), as ``torchrun`` does.  Its two tiers:

* **Data plane** (the feature-extraction fleet, bulk serving): each rank
  works a deterministic contiguous shard of the ref file
  (:func:`process_shard`, :func:`fleet_shard_rows`), so one command line
  serves the whole fleet (``--multihost`` in the stage CLIs).  No
  collective runs.
* **Compute plane** (training): one (data, model) grid of ranks in
  row-major order (:func:`make_global_mesh`).  Each ``model`` group is a run
  of contiguous ranks inside one host, so the gene-head all-reduces stay on
  the host's links; the ``data`` groups span hosts.

Launch, one process per device (``--process_id`` is the global rank and
``--num_processes`` the world size)::

    python -m sequoia_tpu_torch.cli.main --multihost \\
        --coordinator <host0>:8476 --num_processes N --process_id I ...
    torchrun --nproc_per_node 8 -m sequoia_tpu_torch.cli.main --mesh data=4,model=2 ...

``--coordinator`` takes ``HOST:PORT`` (a TCP store on rank 0) or any
``torch.distributed`` init URL (``file:///shared/store``).  Under torchrun
the three flags come from its environment.  The backend is NCCL for CUDA
tensors with gloo for host tensors on a machine with CUDA, gloo alone
otherwise.  Importing this module starts no process group and touches no
GPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

#: seconds a collective, or the rendezvous, may wait before it fails
DEFAULT_TIMEOUT = 600.0


def default_backend() -> str:
    """NCCL for CUDA tensors and gloo for host tensors where CUDA is
    available; gloo alone on a CPU machine."""
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def _in_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               timeout: float = DEFAULT_TIMEOUT) -> None:
    """``dist.init_process_group`` over ``coordinator_address``; a no-op
    when this process already belongs to a group.  Where CUDA is available
    the rank's own device (:func:`rank_device`) becomes the current one,
    whatever the backend.

    Without a coordinator it joins torchrun's world (``env://``); a partial
    coordinator triplet raises, as the JAX package's does."""
    if dist.is_initialized():
        return
    if coordinator_address is None and (num_processes is not None
                                        or process_id is not None):
        raise ValueError("--num_processes/--process_id need --coordinator "
                         "(or launch under torchrun, which sets all three)")
    if coordinator_address is None:
        if not _in_torchrun():
            raise ValueError("--multihost needs --coordinator HOST:PORT, --num_processes "
                             "and --process_id, or a torchrun launch")
        init, kw = "env://", {}
    else:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and --process_id")
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        kw = dict(world_size=int(num_processes), rank=int(process_id))
    dist.init_process_group(backend or default_backend(), init_method=init,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    if torch.cuda.is_available():  # before any collective creates an NCCL communicator
        torch.cuda.set_device(rank_device())


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


_rank, _world = process_index, process_count


def local_world_size() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` where the launcher sets it
    (torchrun, :func:`spawn_local`), else the CUDA device count capped at the
    world, else the whole world (one CPU host)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if torch.cuda.is_available():
        return max(1, min(process_count(), torch.cuda.device_count()))
    return process_count()


def local_rank() -> int:
    """This rank's index on its host: ``LOCAL_RANK`` where the launcher sets
    it, else the global rank modulo the ranks (or CUDA devices) a host has."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or (
        torch.cuda.device_count() if torch.cuda.is_available() else 1)
    return process_index() % max(n, 1)


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else ``cuda:<local rank>``
    where CUDA is available, else the CPU."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", local_rank())
    return torch.device("cpu")


def process_shard(n_rows: int, process_index: int | None = None,
                  process_count: int | None = None) -> tuple[int, int]:
    """This process's contiguous ``[start, end)`` row range, balanced like
    ``np.array_split``: the first ``n_rows % P`` processes get one row more
    (the reference's ``--start/--end`` job arrays, computed)."""
    p = _rank() if process_index is None else process_index
    n = _world() if process_count is None else process_count
    base, extra = divmod(n_rows, n)
    start = p * base + min(p, extra)
    return start, start + base + (1 if p < extra else 0)


@dataclasses.dataclass(eq=False)
class GlobalMesh:
    """A (n_data, n_model) grid of ranks, row-major: rank ``r`` sits at data
    row ``r // n_model``, model column ``r % n_model``.  ``data_group``
    holds this rank's column (the ranks with its model index), over which
    batch rows split and gradients sum; ``model_group`` its row, over which
    the gene head splits."""
    ranks: np.ndarray
    rank: int
    device: torch.device
    data_group: object
    model_group: object

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.ranks.shape[0], "model": self.ranks.shape[1]}

    @property
    def data_index(self) -> int:
        return self.rank // self.ranks.shape[1]

    @property
    def model_index(self) -> int:
        return self.rank % self.ranks.shape[1]


def make_global_mesh(n_model: int = 1, device=None,
                     local_size: int | None = None) -> GlobalMesh:
    """The (data, model) mesh over every rank of the process group.

    Row-major ranks keep each ``model`` group inside one host as long as
    ``n_model`` divides the ranks per host (``local_size``, default
    :func:`local_world_size`); otherwise this raises, as the JAX package's
    does.  Every rank must call it, in the same order (it creates the
    groups)."""
    world = process_count()
    local = local_world_size() if local_size is None else local_size
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model={n_model} must divide the world size {world}")
    if n_model > 1 and local % n_model != 0:
        raise ValueError(f"n_model={n_model} must divide local device count {local} so "
                         "the gene-head TP group stays inside a host")
    ranks = np.arange(world).reshape(-1, n_model)
    data_group = model_group = None
    for j in range(n_model):  # every rank creates every group, in one order
        g = dist.new_group([int(r) for r in ranks[:, j]]) if world > 1 else None
        if j == process_index() % n_model:
            data_group = g
    for i in range(ranks.shape[0]):
        g = dist.new_group([int(r) for r in ranks[i]]) if world > 1 else None
        if i == process_index() // n_model:
            model_group = g
    return GlobalMesh(ranks, process_index(), rank_device(device), data_group, model_group)


#: all-reduces issued through :func:`all_reduce` and their bytes (per rank)
COLLECTIVES = {"calls": 0, "bytes": 0}


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over ``group`` when a process group is up (a world of
    one still runs the backend's all-reduce); returns ``t``.  Only
    ``all_reduce`` is used: gloo offers no other collective on CUDA
    tensors."""
    if dist.is_initialized():
        dist.all_reduce(t, group=group)
        COLLECTIVES["calls"] += 1
        COLLECTIVES["bytes"] += t.numel() * t.element_size()
    return t


def barrier(mesh: GlobalMesh) -> None:
    """Every rank waits for the others (a one-element all-reduce, which
    every backend runs on the mesh's device)."""
    all_reduce(torch.zeros(1, device=mesh.device))


# ---- CLI integration ------------------------------------------------------

def add_fleet_args(parser) -> None:
    """The fleet flags of the stage, training and serving CLIs."""
    g = parser.add_argument_group("multi-host fleet")
    g.add_argument("--multihost", action="store_true",
                   help="shard work across torch.distributed ranks (one per device)")
    g.add_argument("--coordinator", type=str, default=None,
                   help="HOST:PORT of rank 0, or a torch.distributed init URL "
                        "(omit under torchrun)")
    g.add_argument("--num_processes", type=int, default=None,
                   help="world size: the ranks of the whole fleet")
    g.add_argument("--process_id", type=int, default=None, help="this rank")


def fleet_shard_rows(rows, args):
    """``rows`` (a DataFrame or a sequence) cut to this rank's shard under
    ``--multihost`` (after any ``--start/--end`` cut); unchanged without it."""
    if not getattr(args, "multihost", False):
        return rows
    initialize(args.coordinator, args.num_processes, args.process_id, backend="gloo")
    start, end = process_shard(len(rows))
    print(f"[multihost] process {process_index()}/{process_count()} "
          f"rows [{start}:{end}) of {len(rows)}")
    return rows.iloc[start:end] if hasattr(rows, "iloc") else rows[start:end]


def fleet_device(args, device: torch.device) -> torch.device:
    """A stage CLI's device once its rank has joined: under ``--multihost``
    a bare ``cuda`` (the ``--device`` default) becomes this rank's own
    device, ``cuda:<local rank>``; any other device stays as given."""
    if getattr(args, "multihost", False) and device.type == "cuda" and device.index is None:
        return rank_device()
    return device


def mesh_from_args(args, n_model: int = 1, device=None) -> GlobalMesh | None:
    """The training mesh under ``--multihost`` (every rank of the fleet),
    else None."""
    if getattr(args, "multihost", False):
        initialize(args.coordinator, args.num_processes, args.process_id)
        return make_global_mesh(n_model=n_model, device=device)
    return None


# ---- local ranks ------------------------------------------------------------

def _rank_entry(rank, world, init, backend, timeout, devices, fn, args, out):
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    try:
        dev = torch.device(devices[rank]) if devices else None
        if dev is not None and dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=datetime.timedelta(
                                    seconds=min(timeout, DEFAULT_TIMEOUT)))
        try:
            out.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        out.put((rank, False, traceback.format_exc()))


def spawn_local(fn, world: int, args=(), *, backend: str = "gloo", devices=None,
                timeout: float = DEFAULT_TIMEOUT) -> list:
    """Run ``fn(*args)`` on ``world`` local ranks (spawned processes joined
    through a file store) and return their results by rank.  ``devices``:
    each rank's device (``fn`` reads it from ``rank_device``'s rules when
    None).  A rank that fails raises here with its traceback; past
    ``timeout`` seconds every rank is killed and this raises.  A collective
    that waits longer than ``min(timeout, DEFAULT_TIMEOUT)`` fails its rank."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="sequoia_ranks_")
    init = "file://" + os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, init, backend, timeout, devices, fn, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"local ranks did not finish within {timeout} s "
                                   f"(exit codes {[p.exitcode for p in procs]})")
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError(f"a local rank died (exit codes "
                                       f"{[p.exitcode for p in procs]})") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{val}")
            results[rank] = val
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]
