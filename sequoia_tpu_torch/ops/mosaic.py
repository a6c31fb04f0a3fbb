"""Patches assembled from whole raw-YCbCr tiles: the ``'mosaic'`` serving mode.

Counterpart of ``sequoia_tpu/ops/mosaic.py``.  Real Aperio slides store
240-px JPEG tiles while the pipeline's patches are 256 px (reference
``pre_processing/patch_gen_hdf5.py:86-89``), so the per-patch raw mode
(tile dims equal to the patch size, ``serve.SlidePredictor`` ``'ycbcr'``)
never applies to them.  Read per patch, every tile a patch touches is
decoded again (a 256-px window spans about 4.25 tiles of 240 px, against
the grid's 1.14 tiles a patch), and the patches cross to the device as
3 B/px RGB.  Here the tile is the unit of decode and transfer: the host
groups the shuffled candidates (reference ``patch_gen_hdf5.py:100``) into
spatial blocks and reads each block's distinct tiles once as raw planes
(1.5 B/px at 4:2:0); the device rebuilds whole tiles (``ops/ycbcr.py``,
libjpeg's per-tile edge clamping, since each TIFF tile is its own JPEG
image) and takes every patch out of its tile neighbourhood.  Pixels past
the level's edge are masked to the RGB decode's zeros, so an assembled
patch is bit-exact against ``read_region``.

* :func:`plan_chunks` and the other host helpers are pure Python, copied
  from the JAX module.
* :func:`gather_patches` and :func:`make_assemble` are the device side, on
  torch tensors.

Chunks come in spatial order, and each patch carries its position in the
shuffled candidate list (``orig``); the consumer keeps the ``max_patches``
smallest positions, the reference's shuffle-order cap
(``patch_gen_hdf5.py:100-123``).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

from sequoia_tpu_torch.ops import ycbcr


class MosaicChunk(NamedTuple):
    """One group of patches and the tiles they need.

    tiles: (T, 2) int64, the (tx, ty) tile-grid indices to read (T at most
        the planner's tile budget).
    idx:   (P, ky*kx) int32, the stack slot of each neighbourhood cell, row
        major (dy, dx); cells past the grid point at slot ``budget``, the
        neutral black tile's (JAX pads its stack to ``budget + 1`` slots;
        the port's serving producer moves that slot to its stack's last
        row).
    offs:  (P, 2) int32, (row, col) of the patch inside its ky*th x kx*tw
        neighbourhood.
    wh:    (P, 2) int32, the patch's in-bounds (width, height); pixels past
        it are masked to 0 (the RGB decode's fill at the level's edge).
    orig:  (P,) int64, each patch's position in the shuffled candidate list.
    """

    tiles: np.ndarray
    idx: np.ndarray
    offs: np.ndarray
    wh: np.ndarray
    orig: np.ndarray


def neighborhood(coords: Sequence[tuple[int, int]], ps: int,
                 tw: int, th: int) -> tuple[int, int]:
    """(ky, kx): the tile rows and columns a ps-window spans, the most over
    the candidates' offsets (a tile-aligned grid spans exactly 1)."""
    kx = ky = 1
    for x, y in coords:
        kx = max(kx, (x % tw + ps - 1) // tw + 1)
        ky = max(ky, (y % th + ps - 1) // th + 1)
    return ky, kx


def block_tile_capacity(block: int, ps: int, tw: int, th: int) -> int:
    """The most distinct tiles one block x block group of patches can touch."""
    nx = (block * ps - 1 + tw - 1) // tw + 1
    ny = (block * ps - 1 + th - 1) // th + 1
    return nx * ny


def plan_chunks(coords: Sequence[tuple[int, int]], ps: int,
                tile: tuple[int, int], level_dims: tuple[int, int],
                tile_budget: int = 512, block: int = 8,
                ) -> Iterator[MosaicChunk]:
    """Group shuffled candidate coords into spatial chunks.

    Candidates are bucketed into ``block x block``-patch spatial blocks (row
    major); consecutive blocks merge into one chunk while the union of
    their tile neighbourhoods fits ``tile_budget``, so the tiles that
    neighbouring blocks share are read once.
    """
    if not coords:
        return
    tw, th = tile
    w0, h0 = level_dims
    ntx = (w0 + tw - 1) // tw
    nty = (h0 + th - 1) // th
    ky, kx = neighborhood(coords, ps, tw, th)
    tile_budget = max(tile_budget, block_tile_capacity(block, ps, tw, th))

    blocks: dict[tuple[int, int], list[int]] = {}
    for i, (x, y) in enumerate(coords):
        blocks.setdefault((y // (block * ps), x // (block * ps)), []).append(i)

    def patch_rows(members: list[int], slots: dict[tuple[int, int], int]):
        neutral = tile_budget  # the padding slot (black tile)
        for i in members:
            x, y = coords[i]
            tx0, ty0 = x // tw, y // th
            row = [slots[(tx0 + dx, ty0 + dy)]
                   if (tx0 + dx < ntx and ty0 + dy < nty) else neutral
                   for dy in range(ky) for dx in range(kx)]
            yield (i, row, (y % th, x % tw),
                   (max(0, min(ps, w0 - x)), max(0, min(ps, h0 - y))))

    def emit(slots, members):
        rows = list(patch_rows(members, slots))
        tiles = np.asarray(list(slots), np.int64)  # dicts keep insertion order
        return MosaicChunk(
            tiles=tiles,
            idx=np.asarray([r[1] for r in rows], np.int32),
            offs=np.asarray([r[2] for r in rows], np.int32),
            wh=np.asarray([r[3] for r in rows], np.int32),
            orig=np.asarray([r[0] for r in rows], np.int64))

    slots: dict[tuple[int, int], int] = {}
    members: list[int] = []
    for key in sorted(blocks):
        btiles: set[tuple[int, int]] = set()
        for i in blocks[key]:
            x, y = coords[i]
            tx0, ty0 = x // tw, y // th
            btiles.update((tx0 + dx, ty0 + dy)
                          for dy in range(ky) for dx in range(kx)
                          if tx0 + dx < ntx and ty0 + dy < nty)
        fresh = sorted(t for t in btiles if t not in slots)
        if members and len(slots) + len(fresh) > tile_budget:
            yield emit(slots, members)
            slots, members = {}, []
            fresh = sorted(btiles)
        for t in fresh:
            slots[t] = len(slots)
        members.extend(blocks[key])
    if members:
        yield emit(slots, members)


def neutral_planar(tw: int, th: int, sh: int, sv: int) -> np.ndarray:
    """One planar tile that rebuilds to RGB (0, 0, 0): Y = 0, Cb = Cr = 128."""
    ny, nc = ycbcr.planar_sizes(th, tw, sh, sv)
    row = np.full(ny + 2 * nc, 128, np.uint8)
    row[:ny] = 0
    return row


def gather_patches(tiles: torch.Tensor, idx: torch.Tensor, offs: torch.Tensor,
                   wh: torch.Tensor, ps: int, ky: int, kx: int) -> torch.Tensor:
    """(U, th, tw, 3) uint8 rebuilt tiles and a batch's plan -> (B, ps, ps, 3)
    uint8 patches.  Each output pixel (r, c) of patch b lies at row
    ``offs[b, 0] + r``, column ``offs[b, 1] + c`` of the patch's ky*th x kx*tw
    neighbourhood, so one index grid per patch reads it from the tile in
    slot ``idx[b, dy * kx + dx]``: the same pixels as JAX's neighbourhood
    gather and ``lax.dynamic_slice``, without the (B, ky*kx, th, tw, 3)
    neighbourhoods in memory.  Pixels past ``wh`` are masked to 0."""
    _, th, tw, _ = tiles.shape
    dev = tiles.device
    b = idx.shape[0]
    idx = idx.to(dev, torch.int64).reshape(b, ky, kx)
    offs = offs.to(dev, torch.int64)
    r = offs[:, 0, None] + torch.arange(ps, device=dev)  # (B, ps) rows of the neighbourhood
    c = offs[:, 1, None] + torch.arange(ps, device=dev)  # (B, ps) columns
    slot = idx[torch.arange(b, device=dev)[:, None, None], (r // th)[:, :, None],
               (c // tw)[:, None, :]]  # (B, ps, ps)
    flat = slot * (th * tw) + ((r % th) * tw)[:, :, None] + (c % tw)[:, None, :]
    patches = tiles.reshape(-1, 3)[flat]
    return ycbcr.mask_to_valid(patches, wh)


def make_assemble(ps: int, tw: int, th: int, sh: int, sv: int, ky: int, kx: int):
    """``(stack, idx, offs, wh) -> (B, ps, ps, 3)`` uint8, the JAX function's
    contract on torch tensors: ``stack`` is (U, planar bytes) raw planes (the
    last slot neutral), its tiles rebuilt with ``ops/ycbcr.planar_to_rgb``,
    then each patch gathered from them (:func:`gather_patches`).  JAX
    rebuilds the chunk's whole stack on every batch's call; the serving
    consumer rebuilds it once a chunk and gathers each of its batches from
    the same tiles."""

    def assemble(stack, idx, offs, wh) -> torch.Tensor:
        return gather_patches(ycbcr.planar_to_rgb(stack, th, tw, sh, sv), idx, offs, wh,
                              ps, ky, kx)

    return assemble
