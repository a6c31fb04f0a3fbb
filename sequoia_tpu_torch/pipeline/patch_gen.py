"""Stage 1, tiling: WSI -> patches HDF5 + tissue mask, and the slide mask
and candidate grid that serving shares.

Counterpart of ``sequoia_tpu/pipeline/patch_gen.py`` (the reference's
``pre_processing/patch_gen_hdf5.py`` semantics):

* the mask comes from the lowest pyramid level (Otsu HSV-S AND NOT(RGB
  background) AND RGB > 50, dilated then eroded 3 iterations), in the
  reference's [x, y] layout;
* ``patch_size_resized = AppMag / 20 * patch_size``;
* the candidate grid steps ``patch_size_resized`` in both axes and is
  shuffled with the global ``np.random.seed(5)`` + ``np.random.shuffle``;
* a candidate is kept when it hits the coarse mask and passes the tissue
  screen (``ops/masking.patch_keep_flags``, on the device, in batches of
  ``screen_batch``), resized back to ``patch_size`` by Pillow when
  AppMag != 20; tiling stops at ``max_patches_per_slide``.

On-disk contract: ``{patch_path}/{slide_id}/{slide_id}.hdf5`` with one uint8
(ps, ps, 3) dataset per kept tile named ``"{x}_{y}"`` (level-0 coordinates;
``layout="tiles"``) or one chunked ``patches`` (N, ps, ps, 3) dataset and an
int64 ``coords`` (N, 2) one (``layout="packed"``);
``{mask_path}/{slide_id}/mask.npy``; a ``complete.txt`` sentinel.  h5py and
Pillow are imported inside the functions that use them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sequoia_tpu_torch.data.wsi import SlideReader, open_slide, read_regions
from sequoia_tpu_torch.ops import masking
from sequoia_tpu_torch.utils.device import resolve_device
from sequoia_tpu_torch.utils.profiling import count

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
    count("host_syncs", 2)  # the blocking upload of the thumbnail, the mask's readback
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


def extract_patches(slide_path, patches_output_dir: str, mask_path: str, slide_id: str,
                    patch_size: tuple[int, int] = (256, 256),
                    max_patches_per_slide: int | None = None, screen_batch: int = 64,
                    verbose: bool = True, layout: str = "tiles", device=None) -> int:
    """Tile one slide (a path or a reader) on ``device`` (CUDA unless
    given).  Returns the number of patches written, or -1 when the slide's
    ``complete.txt`` says it is done."""
    import h5py

    patch_folder = os.path.join(patches_output_dir, slide_id)
    os.makedirs(patch_folder, exist_ok=True)
    patch_folder_mask = os.path.join(mask_path, slide_id)
    os.makedirs(patch_folder_mask, exist_ok=True)

    if os.path.exists(os.path.join(patch_folder, "complete.txt")):
        if verbose:
            print(f"{slide_id}: patches have already been extracted")
        return -1

    if layout not in ("tiles", "packed"):
        raise ValueError(f"layout must be 'tiles' or 'packed', got {layout!r}")
    dev = resolve_device(device)
    slide = open_slide(slide_path)
    mask, mask_level = compute_slide_mask(slide, device=dev)
    np.save(os.path.join(patch_folder_mask, "mask.npy"), mask)

    indices, psr_x, rf = masked_candidates(slide, mask, mask_level, patch_size[0])
    psr = (psr_x, int(rf * patch_size[1]))
    if verbose:
        print(f"patch size for {slide_id}: {psr}")
    if max_patches_per_slide is None:
        max_patches_per_slide = len(indices)

    n_written = 0
    with h5py.File(os.path.join(patch_folder, f"{slide_id}.hdf5"), "w") as hdf:
        if layout == "packed":
            packed = hdf.create_dataset(
                "patches", shape=(0, *patch_size, 3), maxshape=(None, *patch_size, 3),
                dtype=np.uint8, chunks=(min(64, max_patches_per_slide or 64), *patch_size, 3))
            packed_xy = hdf.create_dataset("coords", shape=(0, 2), maxshape=(None, 2),
                                           dtype=np.int64)

        def write(imgs: list[np.ndarray], xys: list[tuple[int, int]]):
            nonlocal n_written
            if layout == "tiles":
                for img, (x, y) in zip(imgs, xys):
                    hdf.create_dataset(f"{x}_{y}", data=img)
            else:
                n0 = n_written
                packed.resize(n0 + len(imgs), axis=0)
                packed_xy.resize(n0 + len(imgs), axis=0)
                packed[n0:] = np.stack(imgs)
                packed_xy[n0:] = np.asarray(xys, np.int64)
            n_written += len(imgs)

        def screen_and_write(coords: list[tuple[int, int]]):
            imgs = read_regions(slide, coords, 0, psr)
            keep = masking.patch_keep_flags(
                torch.as_tensor(np.ascontiguousarray(imgs), device=dev),
                background_threshold=BACKGROUND_THRESHOLD).cpu().numpy()
            out_imgs, out_xy = [], []
            for img, xy, k in zip(imgs, coords, keep):
                if n_written + len(out_imgs) >= max_patches_per_slide:
                    break
                if not k:
                    continue
                if rf != 1.0:
                    from PIL import Image

                    img = np.asarray(Image.fromarray(img).resize(patch_size))
                out_imgs.append(img)
                out_xy.append(xy)
            if out_imgs:
                write(out_imgs, out_xy)

        pending: list[tuple[int, int]] = []
        for xy in indices:  # already slide-mask screened
            if n_written >= max_patches_per_slide:
                break
            pending.append(xy)
            if len(pending) == screen_batch:
                screen_and_write(pending)
                pending = []
        # once the cap is hit, the pending tail (up to screen_batch - 1
        # full-resolution regions) would be decoded only to be discarded
        if pending and n_written < max_patches_per_slide:
            screen_and_write(pending)

    if n_written == 0:
        if verbose:
            print(f"no patch extracted for slide {slide_id}")
    else:
        with open(os.path.join(patch_folder, "complete.txt"), "w") as f:
            f.write("Process complete!\n")
            f.write(f"Total n patch = {n_written}")
        if verbose:
            print(f"{slide_id} complete, total n patch = {n_written}")
    return n_written


def run_patch_gen(slide_paths: dict[str, str], patch_path: str, mask_path: str,
                  patch_size: int = 256, max_patches_per_slide: int | None = None,
                  verbose: bool = True, layout: str = "tiles", device=None) -> dict[str, int]:
    """Tile a set of slides ``{slide_id: path}``; a slide that fails is
    reported and skipped, as the reference does.  Returns ``{slide_id:
    patches written}`` for the slides that did not fail (-1: already done)."""
    written = {}
    for slide_id, path in slide_paths.items():
        try:
            written[slide_id] = extract_patches(
                path, patch_path, mask_path, slide_id, (patch_size, patch_size),
                max_patches_per_slide, verbose=verbose, layout=layout, device=device)
        except Exception as e:  # per-slide quarantine (reference behaviour)
            print(f"error with slide id {slide_id}: {e}")
    return written
