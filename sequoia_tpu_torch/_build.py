"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Every ``.cu`` file is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library with
a plain C interface under ``build/sequoia_tpu_torch/`` at the root of the
checkout, named by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads the library already built.  The library
is loaded with ``ctypes``; pointers and the CUDA stream travel as
``c_void_p``.  Every C entry returns ``cudaGetLastError()`` and
:func:`check` raises when it is not 0.

There is no fallback: without ``nvcc`` the build raises.  Nothing here runs
when the package is imported.

Launch counts: each kernel wrapper adds to :data:`LAUNCHES` where it launches
its kernel, and nowhere else, so a run can show which kernels it went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "sequoia_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--expt-relaxed-constexpr")

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {"vis_blocks_fused": 0, "stem16": 0,
                            "bottleneck_chain_cp": 0, "bottleneck_chain": 0,
                            "lloyd_stats": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "sq_conv_gemm": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _L, _L, _L, _L, _L, _I, _P],
    "sq_pc_gemm": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _P],
    "sq_pc_wgmma": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                    _P],
    "sq_lloyd_stats": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "sq_vis_blocks": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P, _P],
}

_lib = None


def count_launch(name: str, n: int = 1) -> None:
    LAUNCHES[name] += n


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    found = shutil.which("nvcc")
    toolkit = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if found is None and os.path.exists(toolkit):
        found = toolkit
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of sequoia_tpu_torch "
                           "are built from csrc/ with nvcc at first use")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` (one nvcc each, in parallel) and link the shared
    library; returns its path.  A library with the same source hash is
    reused."""
    so = BUILD_DIR / f"libsequoia_kernels_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [exe, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run([exe, "-shared", "-o", str(tmp_so), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout + link.stderr)
        os.replace(tmp_so, so)  # atomic: a concurrent build sees all or nothing
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
