"""Slide serving, from a whole-slide image or patches to a gene panel.

Counterpart of ``sequoia_tpu/serve.py`` (``SlidePredictor`` for every
``model_type``: the ViS, the ViT and HE2RNA folds):

    predict_wsi(path)             tissue screen -> features -> k-means -> folds
    predict_slides(paths)         the same over a cohort, pipelined
    predict_patches(u8)           features -> k-means -> fold ensemble
    predict_features(feats)       k-means -> fold ensemble
    predict_cluster_features(cf)  fold ensemble only

``predict_wsi`` streams a slide: the slide-level tissue mask and the shuffled
candidate grid (``pipeline/patch_gen.py``) are computed first, then a daemon
thread decodes candidate patches into a bounded queue (it only reads pixels
on the host and touches no CUDA tensor) while the caller's thread screens and
featurises them on the device.  At AppMag 20 (mode ``'rgb'``) each uploaded
batch of candidates goes through the backbone and the tissue screen in one
pass (``_fused_program``) and the rows that fail the screen are dropped; at
other magnifications (``'screened'``) candidates are screened first and the
survivors resized with Pillow to ``patch_size`` before the backbone.  Either
way the kept patches are the first ``max_patches`` candidates that pass the
screen, in the reference's shuffled order, and decoding stops once they are
in.  The kept features stay on the device.  ``predict_slides`` starts slide
i+1's decode before slide i's tail and quarantines a failing slide through
``on_error``.  Over a data-parallel extractor (``FeatureExtractor(mesh=)``)
each batch's backbone and screen run per device shard, and k-means and the
folds run on the mesh's first device, the predictor's.

Real slides store level 0 as chroma-subsampled JPEG tiles, and a reader
that can return their raw YCbCr planes (``ycbcr_subsampling``, and
``tile_dims`` for the mosaic: the port's ``native.NativeTiffReader``) gets
two raw-plane modes at AppMag 20, which send 1.5 B/px at 4:2:0 where
``'rgb'`` sends 3 and rebuild RGB on the device, bit-exact against the RGB
decode (``ops/ycbcr.py``):

* ``'ycbcr'``, tile dims equal to the patch size: each candidate's planes
  and in-bounds extent go up, and the reconstruction, the edge mask, the
  screen and the backbone run on the batch (``_fused_ycbcr_program``);
* ``'mosaic'``, any other tile dims (Aperio's 240-px tiles under 256-px
  patches): each tile is read and uploaded once, rebuilt once per chunk on
  the device, and every patch gathered from its tile neighbourhood
  (``ops/mosaic.py``, ``_fused_mosaic_program``).  Chunks come in spatial
  order, so every candidate is screened and the kept rows are the
  ``max_patches`` smallest shuffle positions, in order, selected with the
  features on the device.

Both keep the same patches as ``'rgb'``.  A raw-plane slide that fails
with ``OSError`` (a strict raw read of a corrupt tile) is served once more
in ``'rgb'``.  With OpenSlide, Pillow or an in-memory reader (the H100
machine, where the native reader does not build, gets OpenSlide or Pillow
from ``open_slide``) serving is ``'rgb'``/``'screened'``, as in JAX.

The fold ensemble is the mean over folds of each fold's prediction (the
reference's 5-fold averaging).  Each fold runs its model's ``apply``: HE2RNA
with the reference's predict-time ReLU before the mean (``he2rna.py:175-190``)
and its k sweep clamped to ``n_clusters`` (a line on stderr; an error where
every k exceeds it).  With ``use_fused_vis`` the ViS folds' blocks run
through the K1 kernel (``ops/cuda_vis.vis_apply_fused``, B = 1 per slide; off
by default, as JAX serves through ``vis.apply``); a fold config outside the
kernel's packed layout (``cuda_vis.kernel_takes``), or a ViT or HE2RNA fold,
raises at construction.  ``use_pallas_kmeans`` (the JAX
name) runs every Lloyd step through the K5 kernel; the extractor's
``cfg`` picks the ResNet kernels (``fused_stages`` for K4).  Slides with
fewer patches than clusters get their empty clusters zero-filled.
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading

import numpy as np
import torch

from sequoia_tpu_torch.data.wsi import open_slide, read_regions
from sequoia_tpu_torch.models import he2rna, vis, vit
from sequoia_tpu_torch.ops import cuda_vis
from sequoia_tpu_torch.ops import kmeans as km
from sequoia_tpu_torch.ops import masking, mosaic, ycbcr
from sequoia_tpu_torch.ops.nn import compute_dtype, precision
from sequoia_tpu_torch.pipeline import patch_gen
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.utils.device import resolve_device, tree_to
from sequoia_tpu_torch.utils.profiling import count, new_request, span


def _aggregator_apply(model_type: str, cfg):
    """``(params, (B, N, D) cluster features) -> (B, G)`` for one fold;
    HE2RNA with the reference's predict-time ReLU."""
    if model_type == "vis":
        return lambda p, x: vis.apply(cfg, p, x)
    if model_type == "vit":
        return lambda p, x: vit.apply(cfg, p, x)
    if model_type == "he2rna":
        return lambda p, x: torch.relu(he2rna.apply(cfg, p, x))
    raise ValueError(f"unknown model_type {model_type!r}")


def _clamp_ks(vis_models, n_clusters: int):
    """HE2RNA folds with their k sweep limited to ``n_clusters`` tokens (a
    converted state dict carries the training-time ks, which can exceed a
    smaller serving ``n_clusters``); an empty sweep raises, since the eval
    forward would then predict 0 for every gene."""
    clamped = []
    for cfg, params in vis_models:
        ks = tuple(k for k in cfg.ks if k <= n_clusters)
        if not ks:
            raise ValueError(f"he2rna ks {tuple(cfg.ks)} all exceed n_clusters={n_clusters}; "
                             "nothing to average")
        if ks != tuple(cfg.ks):
            print(f"he2rna: clamping ks {tuple(cfg.ks)} -> {ks} (n_clusters={n_clusters})",
                  file=sys.stderr)
            cfg = dataclasses.replace(cfg, ks=ks)
        clamped.append((cfg, params))
    return clamped


class SlidePredictor:
    def __init__(self, extractor: FeatureExtractor,
                 vis_models: list[tuple[vis.ViSConfig, dict]], *,
                 model_type: str = "vis", n_clusters: int = 100, max_patches: int = 4000,
                 patch_size: int = 256, kmeans_seed: int = 0,
                 use_pallas_kmeans: bool = False, use_fused_vis: bool = False,
                 device=None):
        """``vis_models``: ``(cfg, params)`` per fold of ``model_type``
        (``"vis"``, ``"vit"`` or ``"he2rna"``)."""
        if model_type not in ("vis", "vit", "he2rna"):
            raise ValueError(f"unknown model_type {model_type!r}")
        if use_fused_vis and model_type != "vis":
            raise ValueError(f"use_fused_vis runs the ViS blocks through the K1 kernel; "
                             f"model_type {model_type!r} has none")
        self.device = resolve_device(device)
        if model_type == "he2rna":
            vis_models = _clamp_ks(vis_models, n_clusters)
        if use_fused_vis:  # before any tensor moves: a refusal costs nothing
            for cfg, _ in vis_models:
                takes, why = cuda_vis.kernel_takes(cfg, compute_dtype(cfg.compute_dtype))
                if not takes:
                    raise ValueError(f"use_fused_vis: the K1 kernel does not take {cfg}: {why}")
        if extractor is not None and extractor.device != self.device:
            raise ValueError(f"extractor runs on {extractor.device}, predictor on "
                             f"{self.device}")
        precision()
        self.extractor = extractor
        self.model_type = model_type
        self.n_clusters = n_clusters
        self.max_patches = max_patches
        self.patch_size = patch_size
        self.kmeans_seed = kmeans_seed
        self.use_pallas = use_pallas_kmeans
        self.vis_models = [(cfg, tree_to(params, self.device)) for cfg, params in vis_models]
        self._applies = [_aggregator_apply(model_type, cfg) for cfg, _ in self.vis_models]
        self._packed = None
        if use_fused_vis:
            self._packed = [cuda_vis.pack_vis_blocks(cfg, params,
                                                     compute_dtype(cfg.compute_dtype))
                            for cfg, params in self.vis_models]
        self._fused_fwd = None
        # host->device audit, cumulative across slides: the patch uploads
        # (screening and features) and the aggregation tail's feature upload
        self.io_stats = {"bytes_uploaded": 0, "candidates": 0, "kept": 0}

    # -- stages -----------------------------------------------------------

    def _candidates(self, wsi_path):
        """Open a slide and screen it coarsely: (slide, level-0 coords passing
        the slide-level tissue mask in shuffled order, patch_size_resized,
        resize_factor), the enumeration of the tiling stage."""
        slide = open_slide(wsi_path)
        mask, mask_level = patch_gen.compute_slide_mask(slide, device=self.device)
        coords, psr, rf = patch_gen.masked_candidates(slide, mask, mask_level,
                                                      self.patch_size)
        return slide, coords, psr, rf

    @staticmethod
    def _decode_chunks(candidates, decode_chunk: int = 64, stop=None):
        """Generator of decoded (n, psr, psr, 3) uint8 candidate chunks, host
        only; ends early once ``stop`` is set."""
        slide, coords, psr, _ = candidates
        for s in range(0, len(coords), decode_chunk):
            if stop is not None and stop.is_set():
                return
            yield read_regions(slide, coords[s:s + decode_chunk], 0, (psr, psr))

    def _upload_counted(self, arr: np.ndarray) -> torch.Tensor:
        """extractor.upload with the host->device byte audit."""
        self.io_stats["bytes_uploaded"] += arr.nbytes
        return self.extractor.upload(arr)

    def _screen(self, imgs: np.ndarray, rf: float) -> np.ndarray:
        """The candidates that pass the tissue screen (on the device), resized
        to ``patch_size`` with Pillow when the slide is not at AppMag 20; the
        span ``serve.screen``."""
        with span("serve.screen", patches=len(imgs)):
            flags = masking.patch_keep_flags(
                self._upload_counted(imgs),
                background_threshold=patch_gen.BACKGROUND_THRESHOLD).cpu().numpy()
            count("host_syncs")  # the flags' readback
        self.io_stats["candidates"] += len(imgs)
        kept = imgs[flags]
        if rf != 1.0 and len(kept):
            from PIL import Image

            ps = self.patch_size
            kept = np.stack([np.asarray(Image.fromarray(im).resize((ps, ps)))
                             for im in kept])
        return kept

    def iter_patch_chunks(self, wsi_path, decode_chunk: int = 64):
        """Generator of tissue-screened uint8 patch chunks from a WSI
        (in memory, no HDF5); stops at ``max_patches`` in all."""
        cands = self._candidates(wsi_path)
        emitted = 0
        for imgs in self._decode_chunks(cands, decode_chunk):
            kept = self._screen(imgs, cands[3])[:self.max_patches - emitted]
            if len(kept):
                emitted += len(kept)
                yield kept
            if emitted >= self.max_patches:
                return

    def iter_raw_chunks(self, wsi_path, decode_chunk: int = 64, stop=None):
        """Generator of unscreened candidate chunks (AppMag 20 slides only)
        for the fused screen + featurise path; honours ``stop``."""
        cands = self._candidates(wsi_path)
        if cands[3] != 1.0:
            raise ValueError("raw chunks require resize_factor 1.0 (AppMag 20); "
                             "use iter_patch_chunks")
        yield from self._decode_chunks(cands, decode_chunk, stop)

    @staticmethod
    def _ycbcr_sub(slide, psr: int):
        """The chroma subsampling where the slide can stream raw YCbCr planes
        per candidate (JPEG tiles whose dims equal the patch size), else
        None."""
        probe = getattr(slide, "ycbcr_subsampling", None)
        if probe is None:
            return None
        try:
            return probe(0, (psr, psr))
        except Exception:
            return None

    @staticmethod
    def _mosaic_layout(slide, psr: int):
        """``(tw, th, sh, sv)`` where the slide's JPEG tiles can feed the tile
        mosaic (tiled level 0, a supported subsampling, tile dims other than
        the patch size: real Aperio slides), else None."""
        dims = getattr(slide, "tile_dims", None)
        probe = getattr(slide, "ycbcr_subsampling", None)
        if dims is None or probe is None:
            return None
        try:
            t = dims(0)
            if t is None or tuple(t) == (psr, psr):
                return None  # equal dims: the per-candidate 'ycbcr' mode
            sub = probe(0, t)
        except Exception:
            return None
        return (*t, *sub) if sub else None

    @staticmethod
    def _decode_ycbcr_chunks(candidates, decode_chunk: int = 64, stop=None):
        """Generator of ``(planes (n, bytes) uint8, wh (n, 2) int32)``
        candidate chunks, host only: each candidate's planar Y ++ Cb ++ Cr
        and its in-bounds (width, height), so the device masks the encoder's
        padding past the level's edge to the RGB decode's zeros."""
        slide, coords, psr, _ = candidates
        xmax, ymax = slide.level_dimensions[0]
        for s in range(0, len(coords), decode_chunk):
            if stop is not None and stop.is_set():
                return
            chunk = coords[s:s + decode_chunk]
            planes = slide.read_regions_ycbcr(chunk, 0, (psr, psr))
            wh = np.asarray([(min(psr, xmax - x), min(psr, ymax - y)) for x, y in chunk],
                            np.int32)
            yield planes, wh

    @staticmethod
    def _decode_mosaic_chunks(candidates, layout, stop=None):
        """Generator of tile-mosaic chunks, host only: ``(stack, idx, offs, wh,
        orig, (ky, kx))``, the chunk's distinct raw tiles and one neutral
        (black) tile last, and each patch's plan (``ops/mosaic.plan_chunks``),
        in spatial order.  JAX pads the stack to the static ``budget + 1``
        rows its compiled program needs; here the stack holds the chunk's
        tiles only and ``idx``'s neutral slot (the budget, past every real
        slot) is moved to its last row, so the padding crosses to no
        device."""
        slide, coords, psr, _ = candidates
        tw, th, sh, sv = layout
        neutral = mosaic.neutral_planar(tw, th, sh, sv)
        ky, kx = mosaic.neighborhood(coords, psr, tw, th)
        for chunk in mosaic.plan_chunks(coords, psr, (tw, th), slide.level_dimensions[0]):
            if stop is not None and stop.is_set():
                return
            locs = [(int(tx * tw), int(ty * th)) for tx, ty in chunk.tiles]
            planes = slide.read_regions_ycbcr(locs, 0, (tw, th))
            stack = np.concatenate([planes, neutral[None]])
            idx = np.minimum(chunk.idx, len(planes)).astype(np.int32)
            yield stack, idx, chunk.offs, chunk.wh, chunk.orig, (ky, kx)

    def iter_raw_ycbcr_chunks(self, wsi_path, decode_chunk: int = 64, stop=None):
        """Generator of unscreened raw-YCbCr candidate chunks, ``(planes,
        wh)``, for slides whose JPEG tiles are patch-sized; honours
        ``stop``."""
        cands = self._candidates(wsi_path)
        if cands[3] != 1.0 or self._ycbcr_sub(cands[0], cands[2]) is None:
            raise ValueError("slide has no raw-YCbCr path; use iter_raw_chunks")
        yield from self._decode_ycbcr_chunks(cands, decode_chunk, stop)

    def iter_mosaic_chunks(self, wsi_path, stop=None):
        """Generator of tile-mosaic chunks (:meth:`_decode_mosaic_chunks`)
        for slides whose JPEG tile dims differ from the patch size."""
        cands = self._candidates(wsi_path)
        layout = self._mosaic_layout(cands[0], cands[2]) if cands[3] == 1.0 else None
        if layout is None:
            raise ValueError("slide has no tile-mosaic path; use iter_raw_chunks")
        yield from self._decode_mosaic_chunks(cands, layout, stop)

    def _shard_program(self, body):
        """``body(raw, params, *rows) -> (features, keep_flags)`` as a
        ``(params, *batch)`` program: per data shard under the extractor's
        mesh (``map_shards``, every part of the batch split alike, ``raw`` the
        one-device backbone), else on the whole batch with ``raw_fwd``."""
        ext = self.extractor
        if getattr(ext, "mesh", None) is None:
            return lambda p, *xs: body(ext.raw_fwd, p, *xs)
        return lambda p, *xs: ext.map_shards(lambda q, *rows: body(ext._one_fwd, q, *rows),
                                             p, *xs)

    @staticmethod
    def _screened(raw, params, u8):
        """The backbone and the tissue screen on one batch on the device."""
        return raw(params, u8), masking.patch_keep_flags(
            u8, background_threshold=patch_gen.BACKGROUND_THRESHOLD)

    def _fused_program(self):
        """``(params, u8 batch on the device) -> (features, keep_flags)``: the
        backbone and the tissue screen on one uploaded batch, so a candidate
        crosses to the device once."""
        if self._fused_fwd is None:
            self._fused_fwd = self._shard_program(self._screened)
        return self._fused_fwd

    def _fused_ycbcr_program(self, sub: tuple[int, int]):
        """``(params, planes, wh) -> (features, keep_flags)``: raw planes in,
        then the RGB reconstruction, the edge mask (which also blackens the
        zero padding rows), the screen and the backbone on the batch; planes
        and ``wh`` shard with the batch under a mesh."""
        ps = self.patch_size

        def body(raw, params, planes, wh):
            rgb = ycbcr.mask_to_valid(ycbcr.planar_to_rgb(planes, ps, ps, *sub), wh)
            return self._screened(raw, params, rgb)

        return self._shard_program(body)

    def _fused_mosaic_program(self, ky: int, kx: int):
        """``(params, tiles, idx, offs, wh) -> (features, keep_flags)``: a
        batch's patches gathered from a chunk's rebuilt tiles
        (``ops/mosaic.gather_patches``), then screened and featurised.  Under
        a mesh ``idx``/``offs``/``wh`` shard with the batch and each shard
        reads the tiles on its own device (``tiles`` maps a device to its
        copy, :meth:`_upload_replicated`)."""
        ps = self.patch_size

        def run(params, tiles, idx, offs, wh):
            def body(raw, p, i, o, w):
                rgb = mosaic.gather_patches(tiles[i.device], i, o, w, ps, ky, kx)
                return self._screened(raw, p, rgb)

            return self._shard_program(body)(params, idx, offs, wh)

        return run

    def _upload_replicated(self, arr: np.ndarray) -> dict:
        """One copy of ``arr`` on each data row's first device (the mosaic's
        tile stack, which every patch of a batch may read), counted once
        per copy; ``{device: tensor}``."""
        mesh = self.extractor.mesh
        devices = [row[0] for row in mesh.devices] if mesh is not None else [self.device]
        copies = {}
        for d in devices:
            with span("serve.upload", bytes=arr.nbytes):
                t = torch.as_tensor(arr).to(d, non_blocking=True)
            if t.device not in copies:
                copies[t.device] = t
                self.io_stats["bytes_uploaded"] += arr.nbytes
        return copies

    def extract_patches(self, wsi_path) -> np.ndarray:
        """Tissue-screened patches from a WSI (in memory, no HDF5)."""
        chunks = list(self.iter_patch_chunks(wsi_path))
        return np.concatenate(chunks) if chunks else np.zeros(
            (0, self.patch_size, self.patch_size, 3), np.uint8)

    @torch.no_grad()
    def cluster(self, feats) -> torch.Tensor:
        """(N, D) patch features -> (n_clusters, D) cluster means on the
        device; the span ``serve.kmeans``, features on the host uploaded in
        ``serve.upload``."""
        if feats.shape[0] == 0:
            raise ValueError("no tissue patches survived screening")
        with span("serve.kmeans"):
            if isinstance(feats, np.ndarray):
                self.io_stats["bytes_uploaded"] += feats.nbytes
            x = torch.as_tensor(feats)
            if x.device.type != self.device.type:
                count("host_syncs")  # a blocking copy from pageable memory
            with span("serve.upload", bytes=x.nbytes):
                x = x.to(self.device).float()
            mask = torch.ones((x.shape[0],), dtype=torch.bool, device=self.device)
            gen = torch.Generator(device=self.device).manual_seed(self.kmeans_seed)
            _, labels, _, _ = km.kmeans_fit(x, mask, gen, n_clusters=self.n_clusters,
                                            use_pallas=self.use_pallas)
            with span("kmeans.means"):
                cf = km.cluster_means(x, labels, mask, self.n_clusters)
                if x.shape[0] < self.n_clusters:
                    # small slide: some clusters are necessarily empty (NaN
                    # means); zero-pad them as the reference's <100-token windows
                    print(f"serve: {x.shape[0]} patches < n_clusters={self.n_clusters}; "
                          f"empty clusters zero-padded", file=sys.stderr)
                    cf = torch.nan_to_num(cf)
        return cf

    @torch.no_grad()
    def predict_cluster_features(self, cf) -> np.ndarray:
        """(N, D) or (B, N, D) cluster features -> fold-averaged (B, G); the
        spans ``serve.folds`` and ``serve.readback``."""
        with span("serve.folds"):
            cf = torch.as_tensor(cf).to(self.device).float()
            if cf.ndim == 2:
                cf = cf[None]
            preds = []
            for i, (cfg, params) in enumerate(self.vis_models):
                if self._packed is None:
                    preds.append(self._applies[i](params, cf))
                else:
                    preds.append(torch.cat([
                        cuda_vis.vis_apply_fused(cfg, params, self._packed[i], cf[b:b + 1])
                        for b in range(cf.shape[0])]))
            genes = torch.stack(preds).mean(0)
        with span("serve.readback"):
            count("host_syncs")  # the genes' readback
            return genes.cpu().numpy()

    def predict_features(self, feats) -> np.ndarray:
        with span("serve.slide"):
            return self.predict_cluster_features(self.cluster(feats))

    def predict_patches(self, patches_u8) -> np.ndarray:
        with span("serve.slide"):
            return self.predict_features(self.extractor.features(patches_u8))

    # -- streaming --------------------------------------------------------

    def _pick_mode(self, cands, force_rgb: bool):
        """``(mode, arg)`` of a slide's candidates, best first: ``'ycbcr'``
        (arg: the subsampling), ``'mosaic'`` (arg: ``(tw, th, sh, sv)``),
        ``'rgb'`` at AppMag 20, else ``'screened'`` (arg: the resize
        factor).  ``force_rgb`` skips the raw-plane modes."""
        slide, _, psr, rf = cands
        if rf != 1.0:
            return "screened", rf
        if not force_rgb:
            sub = self._ycbcr_sub(slide, psr)
            if sub:
                return "ycbcr", sub
            layout = self._mosaic_layout(slide, psr)
            if layout:
                return "mosaic", layout
        return "rgb", rf

    def _start_producer(self, wsi_path, force_rgb: bool = False, request=None):
        """Start one slide's decode: the slide mask and candidate grid are
        computed here, on the caller's thread and the device, and the mode
        picked (:meth:`_pick_mode`); a daemon thread then decodes candidate
        chunks into a bounded queue of 4.  A slide that cannot be opened
        hands its error to the thread, which raises it into :meth:`_consume`
        (per-slide quarantine).  The candidates are the span
        ``serve.candidates`` and each decoded chunk ``serve.decode`` on the
        thread, both of ``request`` (the slide's, :func:`new_request`).

        Returns ``(queue, thread, err, stop, mode, arg)``."""
        try:
            with span("serve.candidates", request=request):
                cands = self._candidates(wsi_path)
            failure = None
        except Exception as e:
            cands, failure = None, e
        mode, arg = self._pick_mode(cands, force_rgb) if cands else ("screened", 1.0)
        q: queue.Queue = queue.Queue(maxsize=4)
        err: list[BaseException] = []
        stop = threading.Event()  # consumer failed or satisfied: end the producer
        chunks = {"ycbcr": lambda: self._decode_ycbcr_chunks(cands, stop=stop),
                  "mosaic": lambda: self._decode_mosaic_chunks(cands, arg, stop=stop)
                  }.get(mode, lambda: self._decode_chunks(cands, stop=stop))

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                if failure is not None:
                    raise failure
                it = chunks()
                while True:
                    with span("serve.decode", request=request):
                        chunk = next(it, None)
                    if chunk is None or not put(chunk):
                        return
            except BaseException as e:  # propagate into the consumer
                err.append(e)
            finally:
                if not put(None):
                    # stop was set: a consumer blocked in q.get() on an empty
                    # queue still needs the sentinel (if the queue is full it
                    # will dequeue a chunk and see stop instead)
                    try:
                        q.put_nowait(None)
                    except queue.Full:
                        pass

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        return q, t, err, stop, mode, arg

    @staticmethod
    def _drain(q, t, err, stop, on_chunk) -> None:
        """Feed each of a producer's chunks to ``on_chunk`` until its
        sentinel or ``stop``; then stop and join the producer, whatever
        happened, and raise its error (per-slide quarantine).  The wait on
        the queue is the span ``serve.decode_wait``."""
        try:
            while not stop.is_set():
                # stop is only set on this thread (``on_chunk``, or the
                # finally below), so checking it before q.get() never blocks
                # on a producer that has already seen it and left
                with span("serve.decode_wait"):
                    chunk = q.get()
                if chunk is None or stop.is_set():
                    break
                on_chunk(chunk)
        finally:
            stop.set()  # a failure here must not strand the producer
            t.join()
        if err:
            raise err[0]

    def _batches(self, parts: tuple, fill: tuple | None = None):
        """Whole extractor batches of the row-aligned arrays ``parts``:
        yields ``(start, n real rows, pieces)``, the tail padded to the batch
        with ``fill`` (one value per part, zeros by default)."""
        bs = self.extractor.batch_size
        fill = fill or (0,) * len(parts)
        for s in range(0, len(parts[0]), bs):
            pieces = [p[s:s + bs] for p in parts]
            n = len(pieces[0])
            if n < bs:
                pieces = [np.concatenate([p, np.full((bs - n,) + p.shape[1:], v, p.dtype)])
                          for p, v in zip(pieces, fill)]
            yield s, n, pieces

    def _run_fused(self, fused, pieces, n: int):
        """One padded batch uploaded and run through a fused program:
        ``(features of its first n rows that pass the screen, their (n,)
        keep flags)``, on the device; counts the n candidates.  The span
        ``serve.backbone``."""
        with span("serve.backbone", patches=n):
            f, fl = fused(self.extractor.params, *(self._upload_counted(p) for p in pieces))
            self.io_stats["candidates"] += n
            fl = fl[:n]
            count("host_syncs")  # the masked select sizes its output on the host
            return f[:n][fl], fl

    @torch.no_grad()
    def _consume(self, q, t, err, stop, mode: str, arg) -> np.ndarray:
        """Drain one slide's producer through the device and run the
        aggregation tail; returns the fold-averaged (1, G) prediction.

        Patches are featurised in whole extractor batches, the tail padded
        with zero rows (zero patches, or zero planes with a zero extent,
        which mask to black: either fails the tissue screen).  ``'rgb'``
        batches are unscreened candidates and go through
        :meth:`_fused_program`, ``'ycbcr'`` ``(planes, wh)`` batches through
        :meth:`_fused_ycbcr_program`; ``'screened'`` chunks are screened and
        resized as they arrive; ``'mosaic'`` selects its rows its own way
        (:meth:`_consume_mosaic`)."""
        if mode == "mosaic":
            return self._consume_mosaic(q, t, err, stop, arg)
        fused = (self._fused_ycbcr_program(arg) if mode == "ycbcr"
                 else self._fused_program() if mode == "rgb" else None)
        bs = self.extractor.batch_size
        feats: list[torch.Tensor] = []
        kept = accepted = 0
        pending: list[tuple] = []  # per chunk, a tuple of its parts
        npending = 0

        def featurise(parts: tuple) -> None:
            nonlocal kept
            for _, n, pieces in self._batches(parts):
                if fused is not None:
                    take = self._run_fused(fused, pieces, n)[0][:self.max_patches - kept]
                else:  # screened, resized and capped on arrival
                    block = self._upload_counted(pieces[0])
                    with span("serve.backbone", patches=n):
                        take = self.extractor.raw_fwd(self.extractor.params, block)[:n]
                kept += len(take)
                self.io_stats["kept"] += len(take)
                if len(take):
                    feats.append(take)
                if kept >= self.max_patches:
                    stop.set()  # enough patches: end the decode early
                    return

        def drain(final: bool) -> None:
            nonlocal pending, npending
            take = npending if final else (npending // bs) * bs
            if not take:
                return
            parts = (tuple(np.concatenate(c) for c in zip(*pending)) if len(pending) > 1
                     else pending[0])
            featurise(tuple(p[:take] for p in parts))
            rest = tuple(p[take:] for p in parts)
            pending, npending = ([rest] if len(rest[0]) else []), len(rest[0])

        def on_chunk(chunk) -> None:
            nonlocal accepted, npending
            if mode == "screened":
                chunk = self._screen(chunk, arg)[:self.max_patches - accepted]
                accepted += len(chunk)
                if accepted >= self.max_patches:
                    stop.set()  # every patch to keep is in: end the decode
            parts = chunk if isinstance(chunk, tuple) else (chunk,)
            pending.append(parts)
            npending += len(parts[0])
            drain(final=False)  # whole device batches only

        self._drain(q, t, err, stop, on_chunk)
        if kept < self.max_patches:
            drain(final=True)
        return self.predict_features(
            torch.cat(feats) if feats else torch.zeros((0, self.extractor.feature_dim)))

    @torch.no_grad()
    def _consume_mosaic(self, q, t, err, stop, layout) -> np.ndarray:
        """Drain a tile-mosaic producer.  Chunks come in spatial order (so
        each tile is read and uploaded once), which the ``max_patches`` cap
        cannot follow on the fly without changing which patches are kept:
        every candidate is screened and featurised, the features of the
        rows that pass stay on the device beside their shuffle positions
        (``orig``, on the host), and whenever more than twice
        ``max_patches`` are held only the ``max_patches`` smallest positions
        are kept.  At the end they are taken in ascending order: the
        reference's shuffle-order cap (``patch_gen_hdf5.py:100-123``), the
        same rows and order as ``'rgb'``.  Memory stays O(max_patches) on
        the host and the device."""
        tw, th, sh, sv = layout
        kfeat = torch.zeros((0, self.extractor.feature_dim), device=self.device)
        korig = np.zeros((0,), np.int64)

        def smallest(kfeat, korig, keep: int):
            order = np.argsort(korig, kind="stable")[:keep]
            count("host_syncs")  # a blocking upload of the order
            return kfeat[torch.as_tensor(order, device=self.device)], korig[order]

        def on_chunk(chunk) -> None:
            nonlocal kfeat, korig
            stack, idx, offs, wh, orig, (ky, kx) = chunk
            prog = self._fused_mosaic_program(ky, kx)
            # each tile rebuilt once a chunk, on each device that gathers
            tiles = {d: ycbcr.planar_to_rgb(planes, th, tw, sh, sv)
                     for d, planes in self._upload_replicated(stack).items()}
            # padding rows assemble the neutral tile (last), masked black
            fill = (stack.shape[0] - 1, 0, 0)
            for s, n, pieces in self._batches((idx, offs, wh), fill):
                f, fl = self._run_fused(lambda p, *xs: prog(p, tiles, *xs), pieces, n)
                kfeat = torch.cat([kfeat, f])
                count("host_syncs")  # the flags' readback
                korig = np.concatenate([korig, orig[s:s + n][fl.cpu().numpy()]])
                if len(korig) > 2 * self.max_patches:
                    kfeat, korig = smallest(kfeat, korig, self.max_patches)

        self._drain(q, t, err, stop, on_chunk)
        kfeat, korig = smallest(kfeat, korig, self.max_patches)
        self.io_stats["kept"] += len(korig)
        return self.predict_features(kfeat)

    def predict_wsi(self, wsi_path) -> np.ndarray:
        """Streaming slide inference: decode on a producer thread, screen and
        featurise on the device, then k-means and the fold ensemble."""
        request = new_request()
        return self._consume_retrying(
            wsi_path, self._start_producer(wsi_path, request=request), request)

    def _consume_retrying(self, wsi_path, producer, request=None) -> np.ndarray:
        """:meth:`_consume`, with one retry in ``'rgb'`` when a raw-plane
        slide (``'ycbcr'``/``'mosaic'``) fails with ``OSError``.  The raw
        read is strict, so a corrupt tile fails loudly instead of feeding
        wrong planes past the screen; the RGB decode of the same slide
        still serves it (the native reader decodes a bad tile black and the
        screen drops it, as the reference gets from OpenSlide).  The span
        ``serve.slide`` of ``request``, the one the producer was given."""
        with span("serve.slide", request=request):
            try:
                return self._consume(*producer)
            except OSError:
                if producer[4] not in ("ycbcr", "mosaic"):
                    raise
                return self._consume(*self._start_producer(wsi_path, force_rgb=True,
                                                           request=request))

    def predict_slides(self, wsi_paths, on_error=None):
        """Cross-slide pipelined serving: while the device works on slide i,
        slide i+1's decode thread is already filling its queue.

        Yields ``(path, (1, G) prediction)``; a failing slide goes to
        ``on_error(path, exc)`` (per-slide quarantine) when given, else
        raises."""
        paths = list(wsi_paths)
        if not paths:
            return
        requests = [new_request() for _ in paths]
        producer = self._start_producer(paths[0], request=requests[0])
        nxt = None
        try:
            for i, path in enumerate(paths):
                nxt = (self._start_producer(paths[i + 1], request=requests[i + 1])
                       if i + 1 < len(paths) else None)
                try:
                    out = self._consume_retrying(path, producer, requests[i])
                except Exception as e:
                    if on_error is None:
                        raise
                    on_error(path, e)
                    out = None
                finally:
                    # hand off before any exception propagates (on_error
                    # itself raising included), so the outer finally always
                    # sees the lookahead
                    producer, nxt = nxt, None
                if out is not None:
                    yield path, out
        finally:
            # also reached when the caller abandons the generator: stop and
            # join the prefetched lookahead thread
            for p in (producer, nxt):
                if p is not None:
                    p[3].set()
                    p[1].join()
