"""Whole-slide-image readers behind one protocol.

Counterpart of ``sequoia_tpu/data/wsi.py`` (a copy: the port imports nothing
of the JAX package).  Readers are pluggable:

* ``OpenSlideReader`` — when ``openslide`` is importable (``.svs``);
* ``native.NativeTiffReader`` — the C++ libtiff reader of
  ``sequoia_tpu_torch/native`` (threaded tile decode), where it builds;
* ``PILReader`` — Pillow-backed: pyramidal TIFF pages or a flat image;
* ``ArrayReader`` — an in-memory numpy pyramid (tests, synthetic slides).

``openslide``, ``PIL`` and the native library are loaded only when a reader
needs them.  The native reader also returns raw YCbCr planes for the
raw-plane serving modes (``serve.py``), which rebuild the same pixels as its
RGB decode, bit for bit.

Interface follows OpenSlide conventions: ``level_dimensions`` is a list of
``(width, height)``; ``read_region((x, y), level, (w, h))`` takes level-0
coordinates and returns an (h, w, 3) uint8 RGB array; ``properties`` carries
metadata like ``aperio.AppMag``.
"""

from __future__ import annotations

import os
from typing import Protocol

import numpy as np


class SlideReader(Protocol):
    level_dimensions: list[tuple[int, int]]
    properties: dict

    @property
    def dimensions(self) -> tuple[int, int]: ...

    def read_region(self, location, level, size) -> np.ndarray: ...


class ArrayReader:
    """In-memory pyramid: list of (h, w, 3) uint8 arrays, level 0 largest."""

    def __init__(self, levels: list[np.ndarray], properties: dict | None = None):
        self.levels = [np.ascontiguousarray(lv) for lv in levels]
        self.level_dimensions = [(lv.shape[1], lv.shape[0]) for lv in self.levels]
        self.properties = properties or {}

    @property
    def dimensions(self) -> tuple[int, int]:
        return self.level_dimensions[0]

    def level_downsample(self, level: int) -> float:
        return self.level_dimensions[0][0] / self.level_dimensions[level][0]

    def read_region(self, location, level, size) -> np.ndarray:
        x0, y0 = location  # level-0 coordinates (OpenSlide convention)
        w, h = size
        ds = self.level_downsample(level)
        lx, ly = int(x0 / ds), int(y0 / ds)
        lv = self.levels[level]
        out = np.zeros((h, w, 3), np.uint8)
        ys = slice(max(ly, 0), min(ly + h, lv.shape[0]))
        xs = slice(max(lx, 0), min(lx + w, lv.shape[1]))
        if ys.stop > ys.start and xs.stop > xs.start:
            out[ys.start - ly: ys.stop - ly, xs.start - lx: xs.stop - lx] = \
                lv[ys, xs, :3]
        return out


class OpenSlideReader:
    def __init__(self, path: str):
        import openslide

        self._slide = openslide.OpenSlide(path)
        self.level_dimensions = list(self._slide.level_dimensions)
        self.properties = dict(self._slide.properties)

    @property
    def dimensions(self):
        return self._slide.dimensions

    def read_region(self, location, level, size) -> np.ndarray:
        region = self._slide.read_region(location, level, size).convert("RGB")
        return np.asarray(region)


class PILReader:
    """Pillow-backed reader: pyramidal TIFF pages or a flat image."""

    def __init__(self, path: str):
        from PIL import Image

        Image.MAX_IMAGE_PIXELS = None
        self._img = Image.open(path)
        self.level_dimensions = []
        self._pages = []
        try:
            n = getattr(self._img, "n_frames", 1)
        except Exception:
            n = 1
        for i in range(n):
            self._img.seek(i)
            self.level_dimensions.append(self._img.size)  # (w, h)
            self._pages.append(i)
        # sort levels by width, largest first (TIFF pages can be unordered)
        order = sorted(range(len(self._pages)),
                       key=lambda i: -self.level_dimensions[i][0])
        self.level_dimensions = [self.level_dimensions[i] for i in order]
        self._pages = [self._pages[i] for i in order]
        self.properties = dict(getattr(self._img, "info", {}) or {})

    @property
    def dimensions(self):
        return self.level_dimensions[0]

    def read_region(self, location, level, size) -> np.ndarray:
        x0, y0 = location
        w, h = size
        ds = self.level_dimensions[0][0] / self.level_dimensions[level][0]
        lx, ly = int(x0 / ds), int(y0 / ds)
        self._img.seek(self._pages[level])
        # crop first: convert("RGB") on the full page would materialize a
        # whole-slide RGB copy per region read
        region = self._img.crop((lx, ly, lx + w, ly + h)).convert("RGB")
        return np.asarray(region)


def open_slide(path_or_reader) -> SlideReader:
    """Open a WSI with the best available backend: OpenSlide (full SVS
    support) > the native C++ libtiff reader (threaded tile decode) >
    Pillow.  A reader passes through unchanged."""
    if not isinstance(path_or_reader, (str, os.PathLike)):
        return path_or_reader
    path = str(path_or_reader)
    try:
        import openslide

        # hasattr guards against a stub module in sys.modules
        if hasattr(openslide, "OpenSlide"):
            try:
                return OpenSlideReader(path)
            except Exception:
                # formats OpenSlide rejects (flat PNG/JPEG) fall through to
                # the native and Pillow backends
                pass
    except ImportError:
        pass
    from sequoia_tpu_torch import native

    if native.available():
        try:
            return native.NativeTiffReader(path)
        except OSError:
            pass  # not a TIFF libtiff opens: Pillow
    return PILReader(path)


#: decode worker threads for batched region reads (the native reader keeps
#: one TIFF handle per worker)
DEFAULT_DECODE_THREADS = 8


def read_regions(slide: SlideReader, locations, level, size,
                 nthreads: int = DEFAULT_DECODE_THREADS) -> np.ndarray:
    """Batch region decode: uses the reader's parallel fast path when it has
    one, else a sequential loop.  Returns (n, h, w, 3) uint8."""
    fast = getattr(slide, "read_regions", None)
    if fast is not None:
        return fast(locations, level, size, nthreads=nthreads)
    return np.stack([slide.read_region(loc, level, size) for loc in locations])
