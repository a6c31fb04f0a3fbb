"""Tracing and throughput accounting.

Counterpart of ``sequoia_tpu/utils/profiling.py``: :class:`StageTimer`
reports items/s and slides/hour per pipeline stage, and
:func:`device_trace` wraps a run in a ``torch.profiler`` trace (CUDA
activity where the card is there) written as a Chrome trace into a
directory (the serve CLI's ``--profile``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time


class StageTimer:
    """Accumulates per-stage wall time and item counts; reports slides/hour."""

    def __init__(self):
        self.stages: dict[str, dict] = {}

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 1):
        t0 = time.perf_counter()
        try:
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

    def to_json(self) -> str:
        return json.dumps(self.stages)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """``torch.profiler`` trace of the body into ``log_dir`` (a Chrome trace,
    ``trace.json``; open it in Perfetto or ``chrome://tracing``); a no-op when
    ``log_dir`` is None.  Traces CUDA activity when a card is there."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
