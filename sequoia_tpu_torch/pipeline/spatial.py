"""Spatial expression maps by sliding windows (stage 8).

Counterpart of ``sequoia_tpu/pipeline/spatial.py`` (reference
``spatial_vis/visualize.py:35-102,185-205``): the valid tile grid comes from
the saved ``mask.npy`` (>= 50% tissue per tile after a 3-iteration
dilation); a ``10 x 10``-tile window slides at ``stride`` over it; windows
holding more than 50 tiles are featurised, zero-padded to the model's token
count and run through every fold's model; every member tile receives the
window's prediction, and overlapping windows average.  Output:
``stride-{stride}.csv`` with ``xcoord, ycoord, xcoord_tf, ycoord_tf``, the
``{gene}_{fold}`` columns and the across-fold mean ``{gene}`` column.

As in JAX, each valid tile is featurised once (the reference re-reads and
re-featurises a tile for every window that holds it) and the windows are
gathers over that feature table, batched through the aggregator; token
order inside a window (the frame's row order) and the zero padding are the
reference's.

The window stage accumulates the overlap sums either on the host (float64
numpy, the parity path) or on the device (``accumulate="device"``): the
feature table is uploaded once, each chunk's windows are gathered from it,
the stacked fold forward gives ``(F, W, G)``, and each window's prediction
is added to its member tiles' rows of an ``(n + 1, F * G_sel)`` f32 sum
buffer by one product with the chunk's ``(n + 1, W)`` membership matrix
(rows of pad index ``n`` land in the extra row, dropped at the end; with TF32
off this sums the same f32 terms as a scatter-add, in another order).
With ``mesh=`` (an in-process ``parallel.sharding.Mesh``) the device stage
is sharded as in JAX: each chunk's windows split over ``data`` (the chunk
rounded up to a multiple of it), every fold's gene head splits by columns
over ``model`` (:func:`make_vis_stacked_predict_fn` with the same mesh), and
the overlap sums and counts are added on the mesh's first device.  pandas
and scipy are imported where a function needs them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sequoia_tpu_torch.ops.nn import precision

BACKGROUND_THRESHOLD = 0.5


def build_valid_tiles(mask_xy: np.ndarray, slide_dims: tuple[int, int],
                      patch_size_resized: int) -> "pd.DataFrame":  # noqa: F821
    """The valid-tile frame of the reference's grid build.  ``mask_xy``: the
    stage-1 ``mask.npy`` ([x, y] layout); ``slide_dims``: level-0 (width,
    height).  A tile whose mask crop is empty (the truncated downsample maps
    edge tiles past the mask) counts as valid, as the reference's
    ``sum() >= 0.5 * 0`` has it."""
    import pandas as pd
    from scipy.ndimage import binary_dilation

    w, h = slide_dims
    downsample = int(w / mask_xy.shape[0])
    ps_in_mask = int(patch_size_resized / downsample)
    mask_rc = np.transpose(mask_xy, (1, 0)) * 1  # [row, col]

    valid = []
    for col in range(0, w - patch_size_resized, patch_size_resized):
        for row in range(0, h - patch_size_resized, patch_size_resized):
            rd, cd = int(row / downsample), int(col / downsample)
            sub = mask_rc[rd:rd + ps_in_mask, cd:cd + ps_in_mask]
            if sub.size == 0:
                valid.append((col, row))
                continue
            sub = binary_dilation(sub, iterations=3)
            if sub.sum() >= BACKGROUND_THRESHOLD * sub.size:
                valid.append((col, row))

    df = pd.DataFrame(valid, columns=["xcoord", "ycoord"])
    df["xcoord_tf"] = ((df["xcoord"] - df["xcoord"].min()) / patch_size_resized).astype(int)
    df["ycoord_tf"] = ((df["ycoord"] - df["ycoord"].min()) / patch_size_resized).astype(int)
    return df


def featurize_tiles(slide, df, patch_size_resized: int, extractor,
                    resize_to: int | None = None, decode_chunk: int = 512) -> np.ndarray:
    """Read and featurise every valid tile once -> (n_tiles, D) f32.

    Tiles not at ``resize_to`` are resized first with the bit-exact Pillow
    BILINEAR resize (the reference's ``transforms.Resize`` on a PIL image),
    on the extractor's device.  ``extractor``: a ``FeatureExtractor`` or any
    callable from (n, ps, ps, 3) uint8 to (n, D) features."""
    from sequoia_tpu_torch.data.wsi import read_regions
    from sequoia_tpu_torch.ops import pil_resize

    dev = getattr(extractor, "device", torch.device("cpu"))
    coords = list(zip(df["xcoord"].astype(int).tolist(), df["ycoord"].astype(int).tolist()))
    feats = []
    for start in range(0, len(coords), decode_chunk):
        tiles = read_regions(slide, coords[start:start + decode_chunk], 0,
                             (patch_size_resized, patch_size_resized))
        if resize_to and tiles.shape[1] != resize_to:
            tiles = pil_resize.resize_u8(torch.from_numpy(tiles).to(dev), resize_to, resize_to)
            if not hasattr(extractor, "features"):
                tiles = tiles.cpu().numpy()
        f = extractor(tiles)
        feats.append(f.cpu().numpy() if isinstance(f, torch.Tensor) else np.asarray(f))
    return np.concatenate(feats, axis=0).astype(np.float32, copy=False)


def collect_windows(df, *, stride: int = 1, window: int = 10) -> list[np.ndarray]:
    """The qualifying windows' member row indices, in the reference's order
    (the frame's rows are column-major over (x, y), as ``window.index``)."""
    xtf = df["xcoord_tf"].to_numpy()
    ytf = df["ycoord_tf"].to_numpy()
    max_x, max_y = int(xtf.max()), int(ytf.max())
    min_tiles = (window * window) / 2
    windows: list[np.ndarray] = []
    for x in range(0, max_x, stride):
        for y in range(0, max_y, stride):
            sel = np.nonzero((xtf >= x) & (xtf < x + window)
                             & (ytf >= y) & (ytf < y + window))[0]
            if sel.shape[0] > min_tiles:
                windows.append(sel)
    return windows


def _sliding_window_device(tile_feats, windows, multi_fn, gene_indices, n, dim, *,
                           num_tokens: int, batch_windows: int, _device_sums: bool = False,
                           mesh=None):
    """The window stage on the device (``accumulate='device'``): the (n, D)
    table crosses to the device once; per chunk the padded windows are
    gathered from it (pad index n selects an appended zero row), the stacked
    fold forward gives (F, W, G) on the device, and the chunk's membership
    matrix adds each window's prediction to its member tiles' rows of the
    (n + 1, F * G_sel) f32 sums (row n takes the pads and is dropped).
    Returns ``(fold_keys, means, seen)``, or with ``_device_sums`` the device
    sums ``{fold: (n, G_sel)}`` and the host counts (a benchmarking hook that
    skips the readback).  ``mesh``: chunks of a multiple of its ``data``
    axis, which ``multi_fn.raw_fwd`` (built on the same mesh) shards."""
    if mesh is not None:
        nd = mesh.shape["data"]
        batch_windows = -(-batch_windows // nd) * nd
    dev = multi_fn.device
    fold_keys = list(multi_fn.fold_keys)
    n_folds, g_sel = len(fold_keys), len(gene_indices)
    table = torch.cat([torch.as_tensor(tile_feats, dtype=torch.float32).to(dev),
                       torch.zeros((1, dim), dtype=torch.float32, device=dev)])
    gene_idx = torch.as_tensor(gene_indices, dtype=torch.long, device=dev)
    full_width = None
    sums = torch.zeros((n + 1, n_folds * g_sel), dtype=torch.float32, device=dev)
    counts = np.zeros(n, np.int64)
    wcol = torch.arange(batch_windows, device=dev)

    with torch.no_grad():
        for start in range(0, len(windows), batch_windows):
            chunk = windows[start:start + batch_windows]
            # gather: the first num_tokens members (the model's token budget);
            # scatter: every member (reference visualize.py:87-100)
            k_scatter = max(num_tokens, max(len(s) for s in chunk))
            gidx = np.full((batch_windows, num_tokens), n, np.int64)
            sidx = np.full((batch_windows, k_scatter), n, np.int64)
            for i, sel in enumerate(chunk):
                gidx[i, :min(len(sel), num_tokens)] = sel[:num_tokens]
                sidx[i, :len(sel)] = sel
            np.add.at(counts, np.concatenate(chunk), 1)

            preds = multi_fn.raw_fwd(table[torch.from_numpy(gidx).to(dev)])  # (F, W, G)
            if full_width is None:
                full_width = preds.shape[2] == g_sel and bool(
                    np.array_equal(gene_indices, np.arange(g_sel)))
            if not full_width:
                preds = preds.index_select(2, gene_idx)
            member = torch.zeros((n + 1, batch_windows), dtype=torch.float32, device=dev)
            s = torch.from_numpy(sidx).to(dev)
            member.index_put_((s, wcol[:, None].expand_as(s)),
                              torch.ones((), dtype=torch.float32, device=dev), accumulate=True)
            # (F, W, G_sel) -> (W, F * G_sel), fold-major columns
            sums.addmm_(member, preds.float().permute(1, 0, 2).reshape(batch_windows, -1))

    per_fold = {f: sums[:n, i * g_sel:(i + 1) * g_sel] for i, f in enumerate(fold_keys)}
    if _device_sums:
        return fold_keys, per_fold, counts
    seen = counts > 0
    host = sums[:n].cpu().numpy().astype(np.float64)  # one download for every fold
    means = {}
    for i, f in enumerate(fold_keys):
        m = np.full((n, g_sel), np.nan)
        m[seen] = host[seen, i * g_sel:(i + 1) * g_sel] / counts[seen, None]
        means[f] = m
    return fold_keys, means, seen


def _host(a) -> np.ndarray:
    return a.float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def sliding_window_predict_arrays(tile_feats: np.ndarray, df, predict_fns, gene_indices, *,
                                  stride: int = 1, window: int = 10, num_tokens: int = 100,
                                  batch_windows: int = 64, accumulate: str = "auto",
                                  _device_sums: bool = False, mesh=None):
    """The reference ``sliding_window_method`` over cached features, every
    fold in one pass over the windows.

    ``predict_fns``: ``{fold: (W, num_tokens, D) -> (W, G)}`` callables, or
    one stacked predictor (:func:`make_vis_stacked_predict_fn`) mapping
    ``(W, num_tokens, D) -> {fold: (W, G)}``.  ``accumulate``: ``"host"``
    (float64 numpy, the reference's per-tile means), ``"device"`` (f32 on the
    device; needs a stacked predictor) or ``"auto"`` (device for a stacked
    predictor at >= 1024 genes).

    Returns ``(fold_keys, means, seen)``: ``means[f]`` is the (n_tiles,
    G_sel) overlap-averaged table, NaN on tiles no window covers."""
    n, dim = tile_feats.shape
    windows = collect_windows(df, stride=stride, window=window)
    gene_indices = np.asarray(list(gene_indices), np.int64)

    if callable(predict_fns):
        multi_fn = predict_fns
        fold_keys = list(getattr(predict_fns, "fold_keys", [])) or None
    else:
        def multi_fn(feats):
            return {f: _host(fn(feats)) for f, fn in predict_fns.items()}

        fold_keys = list(predict_fns)
        multi_fn.device = next((getattr(fn, "device", None) for fn in predict_fns.values()),
                               None)

    raw_fwd = getattr(multi_fn, "raw_fwd", None)
    if accumulate not in ("auto", "host", "device"):
        raise ValueError(f"accumulate must be auto|host|device, got {accumulate!r}")
    if accumulate == "device" and raw_fwd is None:
        raise ValueError("accumulate='device' needs a stacked predictor "
                         "(make_vis_stacked_predict_fn)")
    if mesh is not None and raw_fwd is None:
        raise ValueError("mesh sharding needs a stacked predictor "
                         "(make_vis_stacked_predict_fn built with the same mesh)")
    if accumulate == "auto":
        accumulate = ("device" if raw_fwd is not None
                      and (mesh is not None or len(gene_indices) >= 1024) else "host")
    if mesh is not None and accumulate != "device":
        raise ValueError("mesh sharding requires accumulate='device'")
    if mesh is not None:
        from sequoia_tpu_torch.parallel.sharding import in_process

        in_process(mesh, "sliding_window_predict_arrays(mesh=)")
    if accumulate == "device":
        return _sliding_window_device(tile_feats, windows, multi_fn, gene_indices, n, dim,
                                      num_tokens=num_tokens, batch_windows=batch_windows,
                                      _device_sums=_device_sums, mesh=mesh)
    if _device_sums:
        raise ValueError("_device_sums requires accumulate='device'")

    # folds known up front: zero qualifying windows still give all-NaN tables
    sums: dict = ({f: np.zeros((n, len(gene_indices))) for f in fold_keys}
                  if fold_keys else {})
    counts = np.zeros(n, np.int64)
    dev = getattr(multi_fn, "device", None)
    for start in range(0, len(windows), batch_windows):
        chunk = windows[start:start + batch_windows]
        feats = np.zeros((batch_windows, num_tokens, dim), np.float32)
        for i, sel in enumerate(chunk):
            feats[i, :len(sel)] = tile_feats[sel[:num_tokens]]
        # one upload for every fold where the predictor names its device
        batch = torch.from_numpy(feats).to(dev) if dev is not None else feats
        np.add.at(counts, np.concatenate(chunk), 1)
        fold_preds = multi_fn(batch)
        if not sums:
            fold_keys = list(fold_preds)
            sums = {f: np.zeros((n, len(gene_indices))) for f in fold_keys}
        for f in fold_keys:
            preds = _host(fold_preds[f])  # (W, G)
            if not (len(gene_indices) == preds.shape[1]
                    and np.array_equal(gene_indices, np.arange(preds.shape[1]))):
                preds = preds[:, gene_indices]
            s = sums[f]
            # members are unique within a window: one row-add per window
            for i, sel in enumerate(chunk):
                s[sel] += preds[i]

    seen = counts > 0
    means = {}
    for f in (fold_keys or []):
        m = np.full((n, len(gene_indices)), np.nan)
        m[seen] = sums[f][seen] / counts[seen, None]
        means[f] = m
    return list(fold_keys or []), means, seen


def sliding_window_predict_multi(tile_feats: np.ndarray, df, predict_fns, gene_indices, *,
                                 stride: int = 1, window: int = 10, num_tokens: int = 100,
                                 batch_windows: int = 64, accumulate: str = "auto"):
    """Dict view of :func:`sliding_window_predict_arrays`: ``{fold:
    {gene_index: {row label: prediction}}}`` (the reference's layout)."""
    labels = df.index.to_numpy()
    gene_indices = list(gene_indices)
    fold_keys, means, seen = sliding_window_predict_arrays(
        tile_feats, df, predict_fns, gene_indices, stride=stride, window=window,
        num_tokens=num_tokens, batch_windows=batch_windows, accumulate=accumulate)
    out = {}
    for f in fold_keys:
        m = means[f][seen]
        out[f] = {int(g): {int(lbl): float(v) for lbl, v in zip(labels[seen], m[:, j])}
                  for j, g in enumerate(gene_indices)}
    return out


def sliding_window_predict(tile_feats: np.ndarray, df, predict_fn, gene_indices, *,
                           stride: int = 1, window: int = 10, num_tokens: int = 100,
                           batch_windows: int = 64) -> dict[int, dict[int, float]]:
    """Single-model :func:`sliding_window_predict_multi`."""
    return sliding_window_predict_multi(
        tile_feats, df, {0: predict_fn}, gene_indices, stride=stride, window=window,
        num_tokens=num_tokens, batch_windows=batch_windows)[0]


def run_visualize(slide, mask_xy: np.ndarray, gene_ids: list[str], fold_models, extractor, *,
                  gene_names=None, patch_size: int = 256, resize_factor: float | None = None,
                  stride: int = 1, save_path: str | None = None,
                  resize_patch_to: int | None = None, accumulate: str = "auto",
                  num_tokens: int = 100, mesh=None):
    """One slide's map (reference visualize.py __main__): ``fold_models`` is
    ``{fold: predict_fn}`` or a stacked predictor; ``num_tokens`` the
    models' token budget (100 in the reference's contract).  Returns the
    result frame and writes ``stride-{stride}.csv`` under ``save_path``.
    ``mesh``: the sharded window stage (see the module docstring)."""
    import pandas as pd

    if mesh is not None:
        from sequoia_tpu_torch.parallel.sharding import in_process

        in_process(mesh, "run_visualize(mesh=)")
    if resize_factor is None:
        resize_factor = float(slide.properties.get("aperio.AppMag", 20) or 20) / 20.0
    patch_size_resized = int(resize_factor * patch_size)

    df = build_valid_tiles(mask_xy, slide.dimensions, patch_size_resized)
    res_df = df.copy(deep=True)

    gene_names = list(gene_names) if gene_names is not None else list(gene_ids)
    gene_pos: dict = {}  # list.index: the first occurrence wins
    for i, g in enumerate(gene_ids):
        gene_pos.setdefault(g, i)
    inds = []
    for gname in gene_names:
        if gname in gene_pos:
            inds.append(gene_pos[gname])
        else:
            print(f"gene not in predicted values {gname}")

    tile_feats = featurize_tiles(slide, df, patch_size_resized, extractor,
                                 resize_to=resize_patch_to)
    fold_keys, means, _ = sliding_window_predict_arrays(
        tile_feats, df, fold_models, inds, stride=stride, num_tokens=num_tokens,
        accumulate=accumulate, mesh=mesh)
    folds = sorted(fold_keys)
    # every {gene}_{fold} and mean column in one concat (per-column inserts
    # are quadratic at --gene_names all)
    blocks = [pd.DataFrame(means[fold], columns=[f"{gene_ids[g]}_{fold}" for g in inds],
                           index=res_df.index) for fold in folds]
    fold_mean = (np.nanmean(np.stack([means[f] for f in folds]), axis=0) if folds
                 else np.full((len(res_df), len(inds)), np.nan))
    blocks.append(pd.DataFrame(fold_mean, columns=[gene_ids[g] for g in inds],
                               index=res_df.index))
    res_df = pd.concat([res_df] + blocks, axis=1)

    if save_path:
        os.makedirs(save_path, exist_ok=True)
        res_df.to_csv(os.path.join(save_path, f"stride-{stride}.csv"))
    return res_df


def _device_of(params) -> torch.device:
    leaf = params
    while isinstance(leaf, (dict, list, tuple)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return leaf.device


def _predict_fn(apply_fn, params):
    """``feats -> (W, G)`` on the params' device, without autograd."""
    dev = _device_of(params)

    @torch.no_grad()
    def fn(feats):
        return apply_fn(params, torch.as_tensor(feats).to(dev).float())

    fn.device = dev
    return fn


def make_vis_predict_fn(cfg, params):
    """Batched ViS forward for the windows, on the params' device."""
    from sequoia_tpu_torch.models import vis

    precision()
    return _predict_fn(lambda p, x: vis.apply(cfg, p, x), params)


def make_vit_predict_fn(cfg, params):
    """Batched ViT forward for the windows, on the params' device."""
    from sequoia_tpu_torch.models import vit

    precision()
    return _predict_fn(lambda p, x: vit.apply(cfg, p, x), params)


def make_he2rna_predict_fn(cfg, params):
    """HE2RNA eval forward (the k average, no ReLU: the reference's spatial
    path calls the bare model, visualize.py:78-83)."""
    from sequoia_tpu_torch.models import he2rna

    return _predict_fn(lambda p, x: he2rna.apply(cfg, p, x), params)


def make_vis_stacked_predict_fn(cfg, fold_params: dict, mesh=None):
    """Every fold on one batch of windows: ``(W, T, D) -> {fold: (W, G)}``
    numpy, with ``fold_keys`` (known up front, so slides without a
    qualifying window still get per-fold NaN columns), ``device`` (the
    folds' device) and ``raw_fwd`` (``(W, T, D)`` on the device -> ``(F, W,
    G)`` on the device, for ``accumulate='device'``).  Each fold runs
    ``vis.apply`` batched over the windows.

    ``mesh``: every mesh cell (i, j) holds each fold with its head's j-th
    column block (``sharding.shard_params``; ``cells``); ``raw_fwd`` sends
    the i-th row block of the windows to the cells of row i, launched cell
    by cell with no sync, and joins the (F, W_i, G_j) blocks on the first
    device, ``device``."""
    from sequoia_tpu_torch.models import vis

    precision()
    folds = sorted(fold_params)
    if mesh is None:
        dev = _device_of(fold_params[folds[0]])

        @torch.no_grad()
        def raw_fwd(feats_dev):
            return torch.stack([vis.apply(cfg, fold_params[f], feats_dev) for f in folds])
    else:
        from sequoia_tpu_torch.parallel import sharding as sh
        from sequoia_tpu_torch.pipeline.features import _on

        dev = sh.in_process(mesh, "make_vis_stacked_predict_fn(mesh=)").first
        grids = {f: sh.shard_params(mesh, fold_params[f]) for f in folds}
        cells = [[{f: grids[f][i][j] for f in folds} for j, _ in enumerate(row)]
                 for i, row in enumerate(mesh.devices)]

        @torch.no_grad()
        def raw_fwd(feats_dev):
            nd = mesh.shape["data"]
            if feats_dev.shape[0] % nd:
                raise ValueError(f"{feats_dev.shape[0]} windows not divisible by mesh data "
                                 f"axis {nd}")
            step = feats_dev.shape[0] // nd
            rows = []
            for i, row in enumerate(mesh.devices):
                blocks = []
                for j, d in enumerate(row):
                    with _on(d):
                        x = feats_dev[i * step:(i + 1) * step].to(d, non_blocking=True)
                        blocks.append(torch.stack([vis.apply(cfg, cells[i][j][f], x)
                                                   for f in folds]).to(dev, non_blocking=True))
                rows.append(torch.cat(blocks, dim=2))
            return torch.cat(rows, dim=1)

        raw_fwd.cells = cells

    def multi(feats):
        out = raw_fwd(torch.as_tensor(feats).to(dev).float()).cpu().numpy()
        return {f: out[i] for i, f in enumerate(folds)}

    multi.fold_keys = folds
    multi.device = dev
    multi.raw_fwd = raw_fwd
    return multi
