"""Tracing and throughput accounting.

Counterpart of ``sequoia_tpu/utils/profiling.py``: :class:`StageTimer`
reports items/s and slides/hour per pipeline stage, and
:func:`device_trace` wraps a run in a ``torch.profiler`` trace (CUDA
activity where the card is there) written as a Chrome trace into a
directory (the serve CLI's ``--profile``).

The program's spans and counters.  :func:`span` marks a layer boundary
(``serve.kmeans``, ``kmeans.seed``, ``train.step``, ...) and :func:`count`
counts at one (``kmeans.lloyd_steps``, ``host_syncs``).  Both record only
while a ``torch.profiler`` session records (``device_trace``, the tools'
profilers, the benchmark's traced run), on any thread; there is no other
switch.  Off, a span costs one check of the profiler's state and returns a
shared ``nullcontext``; a count returns at once.  On, a span records:

* a ``record_function`` range of its name, so it lands in the profiler's
  trace beside the device operations it launched (on the thread that
  started the profiler: the profiler records no other thread's ranges);
* its host start and end (``time.perf_counter_ns``);
* its parent, the innermost span open on the same thread;
* its request: the ``request`` it is given, else its parent's, else the
  one :func:`in_request` set on its thread, else its own id (a root span
  starts a request);
* a pair of timing ``torch.cuda.Event``s on the current stream where CUDA is
  in use, read only by :func:`summary` or :func:`records` (the device time
  from its start to its end; on the CPU its host time stands in).

A span never synchronises and never reads a device value.  The records stay
in memory until :func:`clear`; :func:`device_trace` clears them on entry and
writes them beside its trace on exit.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()

#: the host syncs of one ``torch.bincount`` on CUDA, the one library op on
#: the serving path found to synchronise by itself (it reads its input's min
#: and max back to size its output; ``torch.cuda.set_sync_debug_mode``,
#: ``tools/sync_census.py``): the ``host_syncs`` counter adds them where the
#: program calls it
BINCOUNT_SYNCS = 2


def _profiling() -> bool:
    """Whether a profiler session records: the profiler's process-wide flag
    (``torch._C._autograd._profiler_enabled()`` is per thread, and reads
    False on a decode or reader thread)."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "request", "attrs", "id", "parent", "thread", "t0", "t1", "events",
                 "device_ms", "_range")

    def __init__(self, name: str, request, attrs: dict):
        self.name, self.request, self.attrs = name, request, attrs
        self.events = self.device_ms = None

    def __enter__(self):
        stack = _REC.stack()
        top = stack[-1] if stack else None
        self.id = next(_REC.ids)
        self.parent = top.id if top is not None else None
        if self.request is None:
            self.request = (top.request if top is not None
                            else getattr(_REC.local, "request", None) or self.id)
        self.thread = threading.get_ident()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.events = _REC.event_pair()
        if self.events is not None:
            self.events[1].record()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[2].record()
        self._range.__exit__(*exc)
        _REC.stack().pop()
        _REC.spans.append(self)
        return False


class _Recorder:
    """The process's spans and counters (one: the profiler it follows is one
    per process too)."""

    def __init__(self):
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.lock = threading.Lock()
        self.spans: list[_Span] = []
        self.counters: dict[str, float] = {}
        self.pool: dict[int, list] = {}  # device index -> free event pairs

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def event_pair(self):
        """``(device index, start, end)``: two timing events of the current
        CUDA device, or None where CUDA is not in use in this process."""
        if not torch.cuda.is_initialized():
            return None
        dev = torch.cuda.current_device()
        try:
            return self.pool.setdefault(dev, []).pop()
        except IndexError:
            return (dev, torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))

    def resolve(self) -> list[_Span]:
        """The closed spans, each with its device milliseconds read (waiting
        for its end event) and its events back in the pool."""
        spans = list(self.spans)
        for s in spans:
            if s.device_ms is not None:
                continue
            if s.events is None:
                s.device_ms = (s.t1 - s.t0) * 1e-6
                continue
            dev, start, end = s.events
            end.synchronize()
            s.device_ms = start.elapsed_time(end)
            self.pool[dev].append(s.events)
            s.events = None
        return spans


_REC = _Recorder()


def span(name: str, request=None, **attrs):
    """A context manager that records the body as the span ``name`` while a
    profiler records (the module's docstring), and does nothing else.
    ``request``: the id of the request the span belongs to, where it runs on
    another thread than the request's root (:func:`current_request`,
    :func:`new_request`); ``attrs``: numbers or strings kept with the
    record, e.g. ``bytes`` or ``patches``.  A span inside an open span of
    the same name on the same thread is that span: a boundary entered again
    (``predict_patches`` calling ``predict_features``) records once.  Never
    name one ``bench.*``: the benchmark gives those ranges a meaning of its
    own."""
    if not _profiling():
        return _OFF
    st = _REC.stack()
    if st and st[-1].name == name:
        return _OFF
    return _Span(name, request, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if not _profiling():
        return
    with _REC.lock:
        _REC.counters[name] = _REC.counters.get(name, 0) + n


def current_request():
    """The request of the innermost span open on this thread, or None."""
    st = getattr(_REC.local, "stack", None)
    return st[-1].request if st else None


def new_request():
    """A fresh request id for spans on several threads, or None when off."""
    return next(_REC.ids) if _profiling() else None


def in_request(request):
    """A context manager under which a root span opened on this thread
    belongs to ``request`` (a batch's, handed over from the thread that
    uploaded it); a no-op when off or when ``request`` is None."""
    if request is None or not _profiling():
        return _OFF
    return _within(request)


@contextlib.contextmanager
def _within(request):
    prev = getattr(_REC.local, "request", None)
    _REC.local.request = request
    try:
        yield
    finally:
        _REC.local.request = prev


def summary() -> dict:
    """``{"spans": {name: {"count", "host_ms", "self_host_ms", "device_ms"}},
    "counters": {name: value}}`` over the recorded spans.  Self time is a
    span's host time less the part its children on the same thread cover."""
    spans = _REC.resolve()
    covered: dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            covered[s.parent] = covered.get(s.parent, 0) + (s.t1 - s.t0)
    out: dict[str, dict] = {}
    for s in spans:
        a = out.setdefault(s.name, {"count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                                    "device_ms": 0.0})
        a["count"] += 1
        a["host_ms"] += (s.t1 - s.t0) * 1e-6
        a["self_host_ms"] += (s.t1 - s.t0 - covered.get(s.id, 0)) * 1e-6
        a["device_ms"] += s.device_ms
    with _REC.lock:
        counters = dict(_REC.counters)
    return {"spans": out, "counters": counters}


def records() -> list[dict]:
    """One dict a recorded span, in the order they closed: ``name``, ``id``,
    ``parent``, ``request``, ``thread``, ``start_ns`` and ``end_ns`` (host,
    ``perf_counter_ns``), ``device_ms`` and ``attrs``."""
    return [{"name": s.name, "id": s.id, "parent": s.parent, "request": s.request,
             "thread": s.thread, "start_ns": s.t0, "end_ns": s.t1, "device_ms": s.device_ms,
             "attrs": s.attrs} for s in _REC.resolve()]


def clear() -> None:
    """Forget the recorded spans and counters."""
    _REC.resolve()  # the pending events go back to the pool
    _REC.spans = []
    with _REC.lock:
        _REC.counters = {}


class StageTimer:
    """Accumulates per-stage wall time and item counts; reports slides/hour.
    Each stage is also a :func:`span` of its name."""

    def __init__(self):
        self.stages: dict[str, dict] = {}

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 1):
        t0 = time.perf_counter()
        try:
            with span(name, items=items):
                yield
        finally:
            dt = time.perf_counter() - t0
            s = self.stages.setdefault(name, {"seconds": 0.0, "items": 0})
            s["seconds"] += dt
            s["items"] += items

    def rate(self, name: str) -> float:
        s = self.stages.get(name)
        return s["items"] / s["seconds"] if s and s["seconds"] > 0 else 0.0

    def slides_per_hour(self, name: str = None) -> float:
        if name is not None:
            return self.rate(name) * 3600.0
        total = sum(s["seconds"] for s in self.stages.values())
        items = min((s["items"] for s in self.stages.values()), default=0)
        return items / total * 3600.0 if total > 0 else 0.0

    def report(self) -> str:
        return "\n".join(f"{name:24s} {s['items']:8d} items  {s['seconds']:8.2f}s  "
                         f"{self.rate(name):10.2f}/s" for name, s in self.stages.items())


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """``torch.profiler`` trace of the body into ``log_dir`` (a Chrome trace,
    ``trace.json``; open it in Perfetto or ``chrome://tracing``) and, beside
    it, ``spans.json``: the program's spans and counters of the body
    (:func:`summary`, and its ``records`` under that key).  A no-op when
    ``log_dir`` is None.  Traces CUDA activity when a card is there."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(dict(summary(), records=records()), f)
