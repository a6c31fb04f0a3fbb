"""ctypes binding for the native C++ tile reader (``tiffreader.cpp``).

Counterpart of ``sequoia_tpu/native/__init__.py``; ``tiffreader.cpp`` is a
copy of the JAX package's source.  The library is built with ``g++``
(``-ltiff -ljpeg -lpthread``: it needs libtiff's and libjpeg's headers and
libraries) at first use, never at import, into ``build/sequoia_tpu_torch/``
at the root of the checkout, named by a hash of the source and flags, so a
changed source rebuilds and an unchanged one loads the library already
built.  Where the build or the load fails, :func:`available` is False and
:func:`build_error` keeps the compiler's or the loader's message; callers
(``data/wsi.open_slide``) then fall back to the other readers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "tiffreader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sequoia_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-ltiff", "-ljpeg", "-lpthread")

_lib = None
_error: str | None = None


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsequoia_native_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile the library to ``so`` (atomically: a concurrent build sees
    all or nothing); raises with the compiler's message."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / so.name
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(out), str(SOURCE), *LIBS],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed (rc={r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(out, so)


def _bind(lib) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    IP, LP, U8P = ctypes.POINTER(I), ctypes.POINTER(L), ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "str_open": (P, [ctypes.c_char_p]),
        "str_num_levels": (I, [P]),
        "str_level_size": (None, [P, I, IP, IP]),
        "str_read_region": (I, [P, I, L, L, L, L, U8P]),
        "str_read_regions": (I, [P, I, LP, LP, I, L, L, U8P, I]),
        "str_close": (None, [P]),
        "str_description": (I, [P, ctypes.c_char_p, I]),
        "str_tile_dims": (I, [P, I, IP, IP]),
        "str_ycbcr_ok": (I, [P, I, L, L, IP, IP]),
        "str_read_regions_ycbcr": (I, [P, I, LP, LP, I, L, L, U8P, I]),
        "str_write_tiled_ex2": (I, [ctypes.c_char_p, ctypes.POINTER(P), LP, LP, I, I, I, I,
                                    ctypes.c_char_p, I, I]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def get_lib():
    """The loaded library (built first if needed), or None where it cannot
    be built or loaded (see :func:`build_error`)."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        so = _library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        _bind(lib)
    except (OSError, RuntimeError, AttributeError) as e:
        # a failed build, or a library that exists but cannot load (wrong
        # architecture, libtiff missing at run time)
        _error = str(e)
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> str | None:
    """Why the library is unavailable (the compiler's or loader's message),
    or None."""
    get_lib()
    return _error


def write_tiled_tiff(path: str, levels: list[np.ndarray], tile: tuple[int, int] = (64, 64),
                     jpeg_quality: int = 0, description: str = "",
                     subsampling: tuple[int, int] = (2, 2)) -> None:
    """Write (h, w, 3) uint8 arrays as a tiled pyramidal TIFF.

    ``jpeg_quality`` > 0 writes JPEG-compressed YCbCr tiles, the on-disk
    layout of Aperio SVS slides (tile dims must be multiples of 16).
    ``description`` is level 0's ImageDescription; an Aperio-style string
    ("...|AppMag = 20|MPP = 0.5") round-trips through
    :attr:`NativeTiffReader.properties`.  ``subsampling`` is the JPEG chroma
    subsampling: (2, 2) 4:2:0, (2, 1) 4:2:2, (1, 1) 4:4:4."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_error}")
    levels = [np.ascontiguousarray(lv, np.uint8) for lv in levels]
    bufs = (ctypes.c_void_p * len(levels))(
        *[lv.ctypes.data_as(ctypes.c_void_p) for lv in levels])
    ws = np.asarray([lv.shape[1] for lv in levels], np.int64)
    hs = np.asarray([lv.shape[0] for lv in levels], np.int64)
    rc = lib.str_write_tiled_ex2(path.encode(), bufs, _ptr(ws), _ptr(hs), len(levels), tile[0],
                                 tile[1], jpeg_quality, description.encode(), subsampling[0],
                                 subsampling[1])
    if rc == -4:
        raise ValueError(f"JPEG tiles need multiple-of-16 dims, got {tile}")
    if rc == -5:
        raise ValueError(f"unsupported subsampling {subsampling}")
    if rc != 0:
        raise OSError(f"str_write_tiled_ex failed (rc={rc})")


def _ptr(a: np.ndarray, ctype=ctypes.c_int64):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeTiffReader:
    """Slide reader backed by the C++ thread-pool decoder.

    ``read_region`` takes level-0 coordinates (OpenSlide convention);
    ``read_regions`` decodes a batch of equal-size regions in parallel
    without the GIL."""

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native tile reader unavailable: {_error}")
        self._lib = lib
        self._h = lib.str_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open TIFF: {path}")
        self.level_dimensions = []
        for i in range(lib.str_num_levels(self._h)):
            w, h = ctypes.c_int(), ctypes.c_int()
            lib.str_level_size(self._h, i, ctypes.byref(w), ctypes.byref(h))
            self.level_dimensions.append((w.value, h.value))
        self.properties: dict = self._parse_properties()

    def _parse_properties(self) -> dict:
        buf = ctypes.create_string_buffer(65536)
        n = self._lib.str_description(self._h, buf, len(buf))
        props: dict = {}
        if n > 0:
            desc = buf.value.decode(errors="replace")
            props["tiff.ImageDescription"] = desc
            # Aperio SVS: "Aperio ...|AppMag = 40|MPP = 0.25|..."
            for part in desc.split("|"):
                if "=" in part:
                    k, _, v = part.partition("=")
                    k, v = k.strip(), v.strip()
                    if k == "AppMag":
                        props["aperio.AppMag"] = v
                    elif k == "MPP":
                        props["aperio.MPP"] = v
        return props

    @property
    def dimensions(self):
        return self.level_dimensions[0]

    def _to_level(self, x0: int, y0: int, level: int) -> tuple[int, int]:
        lw = self.level_dimensions[level][0]
        if lw <= 0:  # hostile header: a declared zero-width level
            raise OSError(f"level {level} has non-positive width {lw}")
        ds = self.level_dimensions[0][0] / lw
        return int(x0 / ds), int(y0 / ds)

    def _level_coords(self, locations, level) -> tuple[np.ndarray, np.ndarray]:
        xs = np.empty(len(locations), np.int64)
        ys = np.empty(len(locations), np.int64)
        for i, (x0, y0) in enumerate(locations):
            xs[i], ys[i] = self._to_level(x0, y0, level)
        return xs, ys

    def read_region(self, location, level, size) -> np.ndarray:
        x, y = self._to_level(location[0], location[1], level)
        w, h = size
        out = np.empty((h, w, 3), np.uint8)  # the C side fills it, or rc != 0
        rc = self._lib.str_read_region(self._h, level, x, y, w, h, _ptr(out, ctypes.c_uint8))
        if rc != 0:
            raise OSError(f"read_region failed (rc={rc})")
        return out

    def read_regions(self, locations, level, size, nthreads: int = 8) -> np.ndarray:
        """Batch decode: [(x0, y0), ...] level-0 coords -> (n, h, w, 3)."""
        w, h = size
        n = len(locations)
        xs, ys = self._level_coords(locations, level)
        out = np.empty((n, h, w, 3), np.uint8)
        ok = self._lib.str_read_regions(self._h, level, _ptr(xs), _ptr(ys), n, w, h,
                                        _ptr(out, ctypes.c_uint8), nthreads)
        if ok != n:
            # black tiles would feed the model wrong pixels; the per-slide
            # quarantine upstream takes the raise
            raise OSError(f"read_regions decoded {ok}/{n} regions")
        return out

    def tile_dims(self, level: int) -> tuple[int, int] | None:
        """(tile_width, tile_height) of a tiled level, else None."""
        tw, th = ctypes.c_int(), ctypes.c_int()
        ok = self._lib.str_tile_dims(self._h, level, ctypes.byref(tw), ctypes.byref(th))
        return (tw.value, th.value) if ok else None

    def ycbcr_subsampling(self, level: int, size) -> tuple[int, int] | None:
        """Chroma subsampling (sh, sv) when whole-``size``-tile requests at
        ``level`` can be served as raw subsampled YCbCr (JPEG tiles, tile
        dims == size), else None."""
        sh, sv = ctypes.c_int(), ctypes.c_int()
        ok = self._lib.str_ycbcr_ok(self._h, level, size[0], size[1], ctypes.byref(sh),
                                    ctypes.byref(sv))
        return (sh.value, sv.value) if ok else None

    def read_regions_ycbcr(self, locations, level, size, nthreads: int = 8) -> np.ndarray:
        """Batch raw-YCbCr whole-tile decode: [(x0, y0), ...] level-0 coords
        (each a tile-aligned full tile) -> (n, w*h + 2*(w/sh)*(h/sv)) uint8,
        each row planar Y ++ Cb ++ Cr, which the raw-plane serving modes
        (``serve.SlidePredictor``, ``'ycbcr'`` and ``'mosaic'``) rebuild to RGB
        on the device."""
        sub = self.ycbcr_subsampling(level, size)
        if sub is None:
            raise OSError("raw YCbCr path unsupported for this level/size")
        w, h = size
        n = len(locations)
        xs, ys = self._level_coords(locations, level)
        out = np.empty((n, w * h + 2 * (w // sub[0]) * (h // sub[1])), np.uint8)
        ok = self._lib.str_read_regions_ycbcr(self._h, level, _ptr(xs), _ptr(ys), n, w, h,
                                              _ptr(out, ctypes.c_uint8), nthreads)
        if ok != n:
            raise OSError(f"read_regions_ycbcr decoded {ok}/{n} regions "
                          "(tile-aligned whole tiles only)")
        return out

    def close(self):
        if self._h:
            self._lib.str_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
