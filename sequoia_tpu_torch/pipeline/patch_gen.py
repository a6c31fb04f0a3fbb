"""Tiling helpers shared by serving: the slide-level tissue mask and the
coarse candidate grid.

Counterpart of ``sequoia_tpu/pipeline/patch_gen.py:38-86`` (the reference's
``pre_processing/patch_gen_hdf5.py`` semantics):

* the mask comes from the lowest pyramid level (Otsu HSV-S AND NOT(RGB
  background) AND RGB > 50, dilated then eroded 3 iterations), in the
  reference's [x, y] layout;
* ``patch_size_resized = AppMag / 20 * patch_size``;
* the candidate grid steps ``patch_size_resized`` in both axes and is
  shuffled with the global ``np.random.seed(5)`` + ``np.random.shuffle``.

The HDF5 tiling stage (``extract_patches``, ``run_patch_gen``) is not
ported yet (h5py is not on the GPU machine); nothing here imports h5py.
"""

from __future__ import annotations

import numpy as np
import torch

from sequoia_tpu_torch.data.wsi import SlideReader
from sequoia_tpu_torch.ops import masking
from sequoia_tpu_torch.utils.device import resolve_device

BACKGROUND_THRESHOLD = 0.2


def compute_slide_mask(slide: SlideReader, level: str | int = "max", device=None):
    """Low-res tissue mask in the reference's [x, y] layout, computed on
    ``device`` (CUDA unless given): ``(mask bool numpy, level)``."""
    if level == "max":
        level = len(slide.level_dimensions) - 1
    w, h = slide.level_dimensions[level]
    img = slide.read_region((0, 0), level, (w, h))  # (h, w, 3)
    img_xy = torch.as_tensor(np.transpose(img, (1, 0, 2)).copy(),
                             device=resolve_device(device))  # [x, y]
    mask = masking.tissue_mask(img_xy)
    mask = masking.binary_dilation(mask, iterations=3)
    mask = masking.binary_erosion(mask, iterations=3)
    return mask.cpu().numpy(), level


def candidate_grid(xmax: int, ymax: int, step: int, seed: int = 5):
    """Reference candidate enumeration + seeded shuffle (np.random.seed(5))."""
    indices = [(x, y) for x in range(0, xmax, step) for y in range(0, ymax, step)]
    np.random.seed(seed)
    np.random.shuffle(indices)
    return indices


def resize_factor(slide) -> float:
    """AppMag -> level-0 resize factor (reference ``patch_gen_hdf5.py:86-89``:
    patches are read at AppMag/20 x the target size, then resized down)."""
    return float(slide.properties.get("aperio.AppMag", 20) or 20) / 20.0


def masked_candidates(slide, mask: np.ndarray, mask_level, patch_size: int):
    """Level-0 candidate coords passing the slide-level tissue mask ->
    ``(coords, patch_size_resized, resize_factor)``: the one enumeration the
    tiling stage and serving share."""
    ratio_x = slide.level_dimensions[0][0] / slide.level_dimensions[mask_level][0]
    ratio_y = slide.level_dimensions[0][1] / slide.level_dimensions[mask_level][1]
    xmax, ymax = slide.level_dimensions[0]
    rf = resize_factor(slide)
    psr = int(rf * patch_size)
    coords = []
    for x, y in candidate_grid(xmax, ymax, psr):
        xm, ym = int(x / ratio_x), int(y / ratio_y)
        if xm < mask.shape[0] and ym < mask.shape[1] and mask[xm, ym]:
            coords.append((x, y))
    return coords, psr, rf
