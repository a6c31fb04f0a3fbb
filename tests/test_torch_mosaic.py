"""The port's tile mosaic (``sequoia_tpu_torch/ops/mosaic.py``) against the
JAX package's: ``plan_chunks`` identical chunk by chunk, and the assembly
(per-tile reconstruction, the window gather, edge masking) bit-exact
against JAX's ``make_assemble`` and against the native reader's RGB
``read_regions``, at tests/test_mosaic.py's 48-px tiles and 64-px patches."""

import numpy as np
import pytest
import torch

import jax

from sequoia_tpu.ops import mosaic as jmosaic
from sequoia_tpu_torch import native
from sequoia_tpu_torch.ops import mosaic, ycbcr

T = 48   # tile side: a multiple of 16 (JPEG MCUs), not the 64-px patch
PS = 64


def _grid_coords(w, h, ps=PS, seed=5):
    # the reference's shuffled candidate enumeration (patch_gen_hdf5.py:100)
    coords = [(x, y) for x in range(0, w, ps) for y in range(0, h, ps)]
    np.random.seed(seed)
    np.random.shuffle(coords)
    return coords


@pytest.mark.parametrize("tile,block", [((T, T), 4), ((T, 32), 2), ((PS, PS), 2)])
def test_plan_chunks_identical_to_jax(tile, block):
    w, h = 9 * PS + 31, 7 * PS + 9
    coords = _grid_coords(w, h)
    budget = mosaic.block_tile_capacity(block, PS, *tile)
    assert budget == jmosaic.block_tile_capacity(block, PS, *tile)
    assert mosaic.neighborhood(coords, PS, *tile) == jmosaic.neighborhood(coords, PS, *tile)
    got = list(mosaic.plan_chunks(coords, PS, tile, (w, h), tile_budget=budget, block=block))
    want = list(jmosaic.plan_chunks(coords, PS, tile, (w, h), tile_budget=budget, block=block))
    assert len(got) == len(want) > 1
    for g, j in zip(got, want):
        for field in mosaic.MosaicChunk._fields:
            a, b = getattr(g, field), getattr(j, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b)
    origs = np.concatenate([c.orig for c in got])
    assert sorted(origs.tolist()) == list(range(len(coords)))
    for sub in [(2, 2), (2, 1)]:
        np.testing.assert_array_equal(mosaic.neutral_planar(*tile, *sub),
                                      jmosaic.neutral_planar(*tile, *sub))


@pytest.mark.parametrize("sub", [(2, 2), (2, 1)])
def test_assemble_bit_exact_vs_jax_on_random_planes(sub):
    rng = np.random.default_rng(1)
    ny, nc = ycbcr.planar_sizes(T, T, *sub)
    u = 9
    stack = rng.integers(0, 256, (u + 1, ny + 2 * nc), dtype=np.uint8)
    stack[u] = mosaic.neutral_planar(T, T, *sub)
    b, ky, kx = 11, 2, 2
    idx = rng.integers(0, u + 1, (b, ky * kx)).astype(np.int32)
    offs = rng.integers(0, 2 * T - PS + 1, (b, 2)).astype(np.int32)
    wh = rng.integers(0, PS + 1, (b, 2)).astype(np.int32)
    wh[:3] = PS
    want = np.asarray(jax.jit(jmosaic.make_assemble(PS, T, T, *sub, ky, kx))(stack, idx, offs,
                                                                             wh))
    asm = mosaic.make_assemble(PS, T, T, *sub, ky, kx)
    got = asm(*(torch.from_numpy(a) for a in (stack, idx, offs, wh)))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (b, PS, PS, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # the serving route: tiles rebuilt once, then gathered per batch
    tiles = ycbcr.planar_to_rgb(torch.from_numpy(stack), T, T, *sub)
    halves = [mosaic.gather_patches(tiles, *(torch.from_numpy(a[s:s + 6])
                                             for a in (idx, offs, wh)), PS, ky, kx)
              for s in (0, 6)]
    np.testing.assert_array_equal(torch.cat(halves).numpy(), want)


@pytest.mark.skipif(not native.available(), reason="the port's native reader did not build")
@pytest.mark.parametrize("sub", [(2, 2), (2, 1)])
def test_assembly_bit_exact_vs_rgb_read_regions(tmp_path, sub):
    w, h = 6 * PS + 40, 5 * PS + 16  # edge tiles on both axes
    rng = np.random.default_rng(3)
    lv0 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    path = str(tmp_path / "m.tiff")
    native.write_tiled_tiff(path, [lv0], tile=(T, T), jpeg_quality=80, subsampling=sub)
    r = native.NativeTiffReader(path)
    assert r.tile_dims(0) == (T, T) and r.ycbcr_subsampling(0, (T, T)) == sub

    coords = _grid_coords(w, h)
    budget = mosaic.block_tile_capacity(4, PS, T, T)
    ky, kx = mosaic.neighborhood(coords, PS, T, T)
    assert (ky, kx) == (2, 2)  # 64-px offsets mod 48 cycle {0, 16, 32}
    asm = mosaic.make_assemble(PS, T, T, *sub, ky, kx)
    jasm = jax.jit(jmosaic.make_assemble(PS, T, T, *sub, ky, kx))
    neutral = mosaic.neutral_planar(T, T, *sub)
    got = {}
    for c in mosaic.plan_chunks(coords, PS, (T, T), (w, h), tile_budget=budget, block=4):
        locs = [(int(tx * T), int(ty * T)) for tx, ty in c.tiles]
        packed = r.read_regions_ycbcr(locs, 0, (T, T))
        stack = np.empty((budget + 1, packed.shape[1]), np.uint8)
        stack[:len(packed)] = packed
        stack[len(packed):] = neutral
        out = asm(*(torch.from_numpy(a) for a in (stack, c.idx, c.offs, c.wh))).numpy()
        np.testing.assert_array_equal(out, np.asarray(jasm(stack, c.idx, c.offs, c.wh)))
        for o, patch in zip(c.orig, out):
            got[int(o)] = patch
    want = r.read_regions(coords, 0, (PS, PS))
    assert len(got) == len(coords)
    for i in range(len(coords)):
        np.testing.assert_array_equal(got[i], want[i])
    r.close()
