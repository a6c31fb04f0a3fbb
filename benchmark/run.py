"""Run one cell of the benchmark:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root.  The cell's configuration, traffic mix, limits and
metrics come from ``BENCHMARK.json`` and the files it names; the traffic
names the entry (``benchmark/entries/<entry>.py``) that builds the
program's objects, runs set-up and the window, and reads the numbers the
check compares.  The last line of standard output is the result.

Without a CUDA card, or with fewer cards than the cell asks for, the run
stops with exit code 2 and prints no result; so it does when the process
holds a module of the JAX side once the window has closed."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import common  # noqa: E402

#: the caches of the program's builds and compiles, inside the checkout and
#: at fixed paths, so only the first run of a cell there builds them
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda_compute_cache"}


THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")


def load_module(path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root, name: str):
    return load_module(root / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def run_cell(s: dict, *, seed: int, seconds: float, trace: bool, device, t_start: float,
             fault=None) -> tuple[dict, list[dict]]:
    """The result line's object and the numbers compared, for the cell of
    spec ``s`` (``common.spec``) on ``device``."""
    entry = load_module(s["root"] / "entries" / f"{s['traffic']['entry']}.py",
                        f"benchmark_entry_{s['traffic']['entry']}")
    from sequoia_tpu_torch import _build

    so = _build.BUILD_DIR / f"libsequoia_kernels_{_build._digest()}.so"
    had_so = so.exists()
    ctx = {"seed": int(seed), "seconds": float(seconds), "trace": bool(trace),
           "device": device, "config": s["config"], "traffic": s["traffic"],
           "chips": s["cell"]["chips"], "t_start": t_start, "fault": fault}
    out = entry.run(ctx)
    metrics = {}
    if trace:
        for m in s["per_layer"]:
            v = reader(s["root"], m["name"]).read(out["record"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in s["end_to_end"]:
            v = out["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = [{"name": k, "value": out["readings"][k], "limit": s["limits"][k]}
              for k in s["limits"]]
    correct = out["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks)
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": out["device"]}
    tr = (out.get("record") or {}).get("trace")
    if trace and tr:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    notes = dict(out.get("notes", {}), kernels_built_in_setup=not had_so and so.exists(),
                 not_compared={k: v for k, v in out["readings"].items() if k not in s["limits"]})
    if notes:
        print("run: " + ", ".join(f"{k}={v!r}" for k, v in notes.items()), file=sys.stderr)
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(common.CHECKOUT / "build" / sub)
    # one host thread for the CPU-side ops: no pool spinning beside the
    # thread that launches the device work
    for var in THREADS:
        os.environ[var] = "1"
    s = common.spec(common.CHECKOUT / "BENCHMARK.json", args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < s["cell"]["chips"]:
        print(f"no result: the cell needs {s['cell']['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(s, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                              device=torch.device("cuda", 0), t_start=T_START)
    found = common.forbidden_loaded()
    if found:
        print(f"no result: the process holds {found}", file=sys.stderr)
        return 2
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
