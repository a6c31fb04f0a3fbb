"""What every run of the benchmark shares: the files it finds by name, the
device's identity, the host-clock spans, the check of what the process
imported, and the result line."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent          # benchmark/
CHECKOUT = ROOT.parent                          # the checkout's root
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sequoia_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(bench_json: Path, workload: str) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    its traffic mix, its limits and the metrics it reports: each from the
    file of that name under ``benchmark/``."""
    bench = load_json(bench_json)
    root = bench_json.parent / "benchmark"
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def takes(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "cell": cell,
        "config": load_json(bench_json.parent / config["file"]),
        "traffic": load_json(root / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(root / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if takes(m)],
        "per_layer": [m for m in bench["per_layer"] if takes(m)],
        "root": root,
    }


def forbidden_loaded() -> list[str]:
    """Modules of the JAX side that this process holds, compared by whole
    top-level name (``sequoia_tpu_torch`` is not ``sequoia_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def power_limit() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def device_info(torch, dev, chips: int) -> dict:
    """The ``device`` object of the result line."""
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
                "power_limit": power_limit()}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def quantile(values, q: float) -> float:
    """The q-quantile of ``values`` by linear interpolation between order
    statistics (numpy's default rule), over all of them."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Window:
    """The measured window: ``open()`` once set-up is done, ``due()`` says
    whether another item may start, ``close()`` when the last one ended.
    Items started before the deadline all finish inside the window, so a
    rate over it takes all the work and all the time."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.t0 = self.t1 = None

    def open(self) -> float:
        self.t0 = time.perf_counter()
        return self.t0

    def due(self) -> bool:
        return time.perf_counter() - self.t0 < self.seconds

    def close(self) -> float:
        self.t1 = time.perf_counter()
        return self.t1 - self.t0


def launches_per(now: dict, items0: int, before: dict, items: int) -> dict:
    """The program's kernel launches (``_build.LAUNCHES``) since ``before``,
    per item done since ``items0``: the kernels a window ran, by name."""
    n = items - items0
    return {k: (v - before.get(k, 0)) / n for k, v in now.items()
            if n > 0 and v > before.get(k, 0)}


def check_line(checks: list[dict]) -> str:
    """One line of every number compared, each beside its limit."""
    return "checks: " + ", ".join(
        f"{c['name']}={c['value']!r} (limit {c['limit']!r})" for c in checks)


def _finite(v):
    """A reading for strict JSON: a non-finite one (a failed check) as text."""
    return v if math.isfinite(v) else str(v)


def emit(result: dict, checks: list[dict]) -> None:
    """The numbers compared as the last lines of standard error, and the
    result as the last line of standard output, its ``checks`` key last."""
    result = dict(result)
    result["checks"] = {c["name"]: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for c in checks}
    sys.stdout.flush()
    print(check_line(checks), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
