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
folds run on the mesh's first device, the predictor's.  The JAX package's
raw-plane modes (``'ycbcr'``,
``'mosaic'``, read through its native libtiff reader) are not ported yet;
they give the same pixels as ``'rgb'`` there.

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
from sequoia_tpu_torch.ops import masking
from sequoia_tpu_torch.ops.nn import compute_dtype, precision
from sequoia_tpu_torch.pipeline import patch_gen
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.utils.device import resolve_device, tree_to


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
        to ``patch_size`` with Pillow when the slide is not at AppMag 20."""
        flags = masking.patch_keep_flags(
            self._upload_counted(imgs),
            background_threshold=patch_gen.BACKGROUND_THRESHOLD).cpu().numpy()
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

    def _fused_program(self):
        """``(params, u8 batch on the device) -> (features, keep_flags)``: the
        backbone and the tissue screen on one uploaded batch, so a candidate
        crosses to the device once."""
        if self._fused_fwd is None:
            ext = self.extractor
            sharded = getattr(ext, "mesh", None) is not None
            raw = ext._one_fwd if sharded else ext.raw_fwd

            def one(params, u8):
                return raw(params, u8), masking.patch_keep_flags(
                    u8, background_threshold=patch_gen.BACKGROUND_THRESHOLD)

            # per data shard under the extractor's mesh
            self._fused_fwd = (lambda p, u8: ext.map_shards(one, p, u8)) if sharded else one
        return self._fused_fwd

    def extract_patches(self, wsi_path) -> np.ndarray:
        """Tissue-screened patches from a WSI (in memory, no HDF5)."""
        chunks = list(self.iter_patch_chunks(wsi_path))
        return np.concatenate(chunks) if chunks else np.zeros(
            (0, self.patch_size, self.patch_size, 3), np.uint8)

    @torch.no_grad()
    def cluster(self, feats) -> torch.Tensor:
        """(N, D) patch features -> (n_clusters, D) cluster means on the device."""
        if feats.shape[0] == 0:
            raise ValueError("no tissue patches survived screening")
        if isinstance(feats, np.ndarray):
            self.io_stats["bytes_uploaded"] += feats.nbytes
        x = torch.as_tensor(feats).to(self.device).float()
        mask = torch.ones((x.shape[0],), dtype=torch.bool, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.kmeans_seed)
        _, labels, _, _ = km.kmeans_fit(x, mask, gen, n_clusters=self.n_clusters,
                                        use_pallas=self.use_pallas)
        cf = km.cluster_means(x, labels, mask, self.n_clusters)
        if x.shape[0] < self.n_clusters:
            # small slide: some clusters are necessarily empty (NaN means);
            # zero-pad them as the reference's <100-token windows
            print(f"serve: {x.shape[0]} patches < n_clusters={self.n_clusters}; "
                  f"empty clusters zero-padded", file=sys.stderr)
            cf = torch.nan_to_num(cf)
        return cf

    @torch.no_grad()
    def predict_cluster_features(self, cf) -> np.ndarray:
        """(N, D) or (B, N, D) cluster features -> fold-averaged (B, G)."""
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
        return torch.stack(preds).mean(0).cpu().numpy()

    def predict_features(self, feats) -> np.ndarray:
        return self.predict_cluster_features(self.cluster(feats))

    def predict_patches(self, patches_u8) -> np.ndarray:
        return self.predict_features(self.extractor.features(patches_u8))

    # -- streaming --------------------------------------------------------

    def _start_producer(self, wsi_path):
        """Start one slide's decode: the slide mask and candidate grid are
        computed here, on the caller's thread and the device; a daemon
        thread then decodes candidate chunks into a bounded queue of 4.  The
        mode is ``'rgb'`` at AppMag 20 and ``'screened'`` otherwise.  A slide
        that cannot be opened hands its error to the thread, which raises it
        into :meth:`_consume` (per-slide quarantine).

        Returns ``(queue, thread, err, stop, mode, resize_factor)``."""
        try:
            cands = self._candidates(wsi_path)
            failure = None
        except Exception as e:
            cands, failure = None, e
        rf = cands[3] if cands else 1.0
        mode = "rgb" if cands and rf == 1.0 else "screened"
        q: queue.Queue = queue.Queue(maxsize=4)
        err: list[BaseException] = []
        stop = threading.Event()  # consumer failed or satisfied: end the producer

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
                for chunk in self._decode_chunks(cands, stop=stop):
                    if not put(chunk):
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
        return q, t, err, stop, mode, rf

    @torch.no_grad()
    def _consume(self, q, t, err, stop, mode: str, rf: float) -> np.ndarray:
        """Drain one slide's producer through the device and run the
        aggregation tail; returns the fold-averaged (1, G) prediction.

        Patches are featurised in whole extractor batches, the tail padded
        with zero patches (they fail the tissue screen).  ``'rgb'`` batches
        are unscreened candidates and go through :meth:`_fused_program`;
        ``'screened'`` chunks are screened and resized as they arrive."""
        fused = self._fused_program() if mode == "rgb" else None
        bs = self.extractor.batch_size
        feats: list[torch.Tensor] = []
        kept = accepted = 0
        pending: list[np.ndarray] = []
        npending = 0

        def featurise(block: np.ndarray) -> None:
            nonlocal kept
            for s in range(0, len(block), bs):
                piece = block[s:s + bs]
                n = len(piece)
                if n < bs:
                    piece = np.concatenate([piece, np.zeros((bs - n,) + piece.shape[1:],
                                                            piece.dtype)])
                u8 = self._upload_counted(piece)
                if mode == "rgb":
                    f, fl = fused(self.extractor.params, u8)
                    self.io_stats["candidates"] += n
                    take = f[fl][:self.max_patches - kept]
                else:  # screened, resized and capped on arrival
                    take = self.extractor.raw_fwd(self.extractor.params, u8)[:n]
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
            block = np.concatenate(pending) if len(pending) > 1 else pending[0]
            featurise(block[:take])
            rest = block[take:]
            pending, npending = ([rest] if len(rest) else []), len(rest)

        try:
            while not stop.is_set():
                # stop is only set on this thread (the cap, or the finally
                # below), so checking it before q.get() never blocks on a
                # producer that has already seen it and left
                chunk = q.get()
                if chunk is None or stop.is_set():
                    break
                if mode == "screened":
                    chunk = self._screen(chunk, rf)[:self.max_patches - accepted]
                    accepted += len(chunk)
                    if accepted >= self.max_patches:
                        stop.set()  # every patch to keep is in: end the decode
                pending.append(chunk)
                npending += len(chunk)
                drain(final=False)  # whole device batches only
            if kept < self.max_patches:
                drain(final=True)
        finally:
            stop.set()  # a failure here must not strand the producer
            t.join()
        if err:
            raise err[0]
        if not feats:
            return self.predict_features(torch.zeros((0, self.extractor.feature_dim)))
        return self.predict_features(torch.cat(feats))

    def predict_wsi(self, wsi_path) -> np.ndarray:
        """Streaming slide inference: decode on a producer thread, screen and
        featurise on the device, then k-means and the fold ensemble."""
        return self._consume_retrying(wsi_path, self._start_producer(wsi_path))

    def _consume_retrying(self, wsi_path, producer) -> np.ndarray:
        """:meth:`_consume`.  The JAX package retries a failed raw-plane
        slide (``'ycbcr'``/``'mosaic'``) once in ``'rgb'`` here; the port
        streams ``'rgb'`` and ``'screened'`` only, which have no retry."""
        return self._consume(*producer)

    def predict_slides(self, wsi_paths, on_error=None):
        """Cross-slide pipelined serving: while the device works on slide i,
        slide i+1's decode thread is already filling its queue.

        Yields ``(path, (1, G) prediction)``; a failing slide goes to
        ``on_error(path, exc)`` (per-slide quarantine) when given, else
        raises."""
        paths = list(wsi_paths)
        if not paths:
            return
        producer = self._start_producer(paths[0])
        nxt = None
        try:
            for i, path in enumerate(paths):
                nxt = self._start_producer(paths[i + 1]) if i + 1 < len(paths) else None
                try:
                    out = self._consume_retrying(path, producer)
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
