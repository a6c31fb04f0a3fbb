"""Host data plane: reference-file parsing, the HDF5 feature store, batching.

Counterpart of ``sequoia_tpu/data/dataset.py``.  On-disk contracts, the
reference's:

* ref file: a CSV with ``wsi_file_name, patient_id, rna_{GENE}...`` and
  optionally ``tcga_project``;
* feature store: ``{features_path}/{project}/{wsi}/{wsi}.h5`` holding
  ``resnet_features`` (N, 2048) / ``uni_features`` (N, 1024) /
  ``cluster_features`` (100, D);
* non-GTEx paths drop a stray ``.svs`` (reference ``read_data.py:44-46``);
  unreadable slides are skipped, as the reference's collate filter skips
  them.

``BatchLoader`` pads every batch to ``batch_size`` with a ``valid`` mask, as
the JAX loader does, and draws its shuffle from
``np.random.default_rng(seed + epoch)``: its batch stream is the JAX
loader's, row for row.

pandas and h5py are imported inside the functions that use them (the GPU
machine has no h5py; callers there feed ``FeatureDataset.load_features``
another way).  ``FeatureDataset`` reads the gene targets and slide names out
of its frame once, at construction, where the JAX dataset indexes the frame
per sample; the values are the same.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np


def read_ref_file(path_or_df, tcga_projects=None) -> "pd.DataFrame":  # noqa: F821
    import pandas as pd

    df = pd.read_csv(path_or_df) if isinstance(path_or_df, str) else path_or_df
    if tcga_projects and "tcga_project" in df.columns:
        df = df[df["tcga_project"].isin(list(tcga_projects))].reset_index(drop=True)
    return df


def gene_names(df: "pd.DataFrame") -> list[str]:  # noqa: F821
    """The gene order contract: the ``rna_`` columns in file order."""
    return [c[4:] for c in df.columns if c.startswith("rna_")]


def slide_h5_path(features_path: str, project: str, wsi: str) -> str:
    path = os.path.join(features_path, str(project), str(wsi), str(wsi) + ".h5")
    # the reference's quirk, kept: the GTEX check and the .svs strip apply
    # to the WHOLE joined path, the store root included
    if "GTEX" not in path:
        path = path.replace(".svs", "")
    return path


def filter_no_features(df: "pd.DataFrame", feature_path: str,  # noqa: F821
                       feature_name: str = "cluster_features",
                       verbose: bool = True) -> "pd.DataFrame":  # noqa: F821
    """Drop the rows whose feature ``.h5`` is missing or lacks
    ``feature_name`` (reference ``src/utils.py:21-41``)."""
    import h5py

    keep = []
    for _, row in df.iterrows():
        path = slide_h5_path(feature_path, row.get("tcga_project", ""), row["wsi_file_name"])
        ok = False
        if os.path.exists(path):
            try:
                with h5py.File(path, "r") as f:
                    ok = feature_name in f.keys()
            except OSError:
                ok = False
        keep.append(ok)
    out = df[np.asarray(keep, bool)].reset_index(drop=True)
    if verbose:
        print(f"filter_no_features[{feature_name}]: {df.shape[0]} -> {out.shape[0]} slides")
    return out


@dataclasses.dataclass
class FeatureDataset:
    """The reference ``SuperTileRNADataset`` over the feature store.

    ``feature_use`` names the dataset read and probed (the reference's
    intended ``cluster_features``, ``read_data.py:48``).  ``num_tokens`` is
    the token count of the first readable slide."""

    df: "pd.DataFrame"  # noqa: F821
    features_path: str
    feature_use: str = "cluster_features"

    def __post_init__(self):
        self.df = self.df.reset_index(drop=True)
        self._rna_cols = [c for c in self.df.columns if c.startswith("rna_")]
        self.num_genes = len(self._rna_cols)
        self.genes = [c[4:] for c in self._rna_cols]
        self._rna = self.df[self._rna_cols].to_numpy(dtype=np.float32)
        projects = (self.df["tcga_project"] if "tcga_project" in self.df.columns
                    else [""] * len(self.df))
        self._meta = [(str(w), str(p)) for w, p in zip(self.df["wsi_file_name"], projects)]
        self.feature_dim = self._probe_feature_dim()

    def _probe_feature_dim(self) -> int:
        for i in range(len(self.df)):
            feats = self.load_features(i)
            if feats is not None:
                self.num_tokens = int(feats.shape[0])
                return feats.shape[-1]
        raise FileNotFoundError(
            f"No readable '{self.feature_use}' features under {self.features_path}")

    def __len__(self) -> int:
        return len(self.df)

    def h5_path(self, idx: int) -> str:
        wsi, project = self._meta[idx]
        return slide_h5_path(self.features_path, project, wsi)

    def load_features(self, idx: int) -> np.ndarray | None:
        """(tokens, D) float32, or None where unreadable (skipped
        downstream)."""
        import h5py

        try:
            with h5py.File(self.h5_path(idx), "r") as f:
                return np.asarray(f[self.feature_use][:], dtype=np.float32)
        except (OSError, KeyError):
            return None

    def load_rna(self, idx: int) -> np.ndarray:
        return self._rna[idx]

    def meta(self, idx: int) -> tuple[str, str]:
        return self._meta[idx]


@dataclasses.dataclass
class Batch:
    features: np.ndarray  # (B, T, D) f32, zero rows where ~valid
    rna: np.ndarray       # (B, G) f32
    valid: np.ndarray     # (B,) bool, False for padding
    wsi: list[str]
    project: list[str]

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())


class BatchLoader:
    """Fixed-shape batches with a validity mask.

    Unreadable slides are dropped before batching.  With ``shuffle=True`` the
    order of each epoch comes from ``np.random.default_rng(seed + epoch)``.
    ``num_tokens`` pads or truncates every batch to that many tokens; None
    pads to the batch's longest slide."""

    def __init__(self, dataset: FeatureDataset, batch_size: int = 16,
                 shuffle: bool = False, seed: int = 0, num_tokens: int | None = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_tokens = num_tokens
        self._epoch = 0

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1

        B = self.batch_size
        pend_feats, pend_rna, pend_wsi, pend_proj = [], [], [], []

        def flush():
            n = len(pend_feats)
            T = self.num_tokens or max(f.shape[0] for f in pend_feats)
            feats = np.zeros((B, T, pend_feats[0].shape[-1]), np.float32)
            for i, f in enumerate(pend_feats):
                feats[i, :f.shape[0]] = f[:T]
            rna = np.zeros((B, self.ds.num_genes), np.float32)
            rna[:n] = np.stack(pend_rna)
            valid = np.zeros((B,), bool)
            valid[:n] = True
            return Batch(feats, rna, valid, list(pend_wsi), list(pend_proj))

        for idx in order:
            f = self.ds.load_features(int(idx))
            if f is None:
                continue
            pend_feats.append(f)
            pend_rna.append(self.ds.load_rna(int(idx)))
            wsi, proj = self.ds.meta(int(idx))
            pend_wsi.append(wsi)
            pend_proj.append(proj)
            if len(pend_feats) == B:
                yield flush()
                pend_feats, pend_rna, pend_wsi, pend_proj = [], [], [], []
        if pend_feats:
            yield flush()


class PrefetchIterator:
    """A background thread reading ahead of any batch iterator (h5py
    releases the GIL during HDF5 reads, so one reader keeps the device fed).
    An error in the reader reaches the consumer; an exhausted iterator keeps
    raising ``StopIteration``; ``close`` unblocks and joins the reader."""

    _SENTINEL = object()

    def __init__(self, iterable, depth: int = 2, transform=None):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None
        self._done = False
        self._stop = threading.Event()  # the consumer is gone: unblock the worker

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in iterable:
                    if transform is not None:
                        # on this thread: an upload issued here overlaps the
                        # consumer's work
                        item = transform(item)
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 — handed to the consumer
                self._err = e
            finally:
                if not put(self._SENTINEL):
                    try:  # a blocked consumer still wakes
                        self._q.put_nowait(self._SENTINEL)
                    except queue.Full:
                        pass

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set() or self._done:
            raise StopIteration  # another get() would block forever
        item = self._q.get()
        if item is self._SENTINEL:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the reader without draining it (an abandoned iteration)."""
        self._stop.set()
        self._t.join()

    def __del__(self):  # never join from a finalizer
        self._stop.set()


def prefetch(loader, depth: int = 2, transform=None):
    """Iterate ``loader`` with ``depth`` batches read ahead on a thread;
    ``transform`` runs on that thread before each batch is queued."""
    return PrefetchIterator(iter(loader), depth=depth, transform=transform)
