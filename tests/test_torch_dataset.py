"""Port data/dataset.py against the JAX package on a synthetic h5 feature
store with two broken slides: the filter, the dataset, the loader's batches
over two shuffled epochs (equal, row for row), and the prefetch thread."""

import threading

import numpy as np
import pandas as pd
import pytest

from sequoia_tpu.data import dataset as jds
from sequoia_tpu_torch.data import dataset as tds
from tests.test_data_and_train import make_store

BROKEN = (2, 7)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store"))
    return root, make_store(root, n_slides=15, n_genes=5, dim=8, tokens=6, broken=BROKEN)


def test_filter_no_features_matches_jax(store):
    root, df = store
    got = tds.filter_no_features(df, root, "cluster_features", verbose=False)
    pd.testing.assert_frame_equal(got, jds.filter_no_features(df, root, "cluster_features",
                                                              verbose=False))
    assert len(got) == len(df) - len(BROKEN)
    assert len(tds.filter_no_features(df, root, "resnet_features", verbose=False)) == 0


def test_feature_dataset_matches_jax(store):
    root, df = store
    j, t = jds.FeatureDataset(df, root), tds.FeatureDataset(df, root)
    assert (t.num_genes, t.feature_dim, t.num_tokens, t.genes) == (
        j.num_genes, j.feature_dim, j.num_tokens, j.genes)
    for i in range(len(df)):
        assert t.h5_path(i) == j.h5_path(i) and t.meta(i) == j.meta(i)
        np.testing.assert_array_equal(t.load_rna(i), j.load_rna(i))
        jf, tf = j.load_features(i), t.load_features(i)
        assert (jf is None) == (tf is None) == (i in BROKEN)
        if tf is not None:
            np.testing.assert_array_equal(tf, jf)
    assert tds.gene_names(df) == jds.gene_names(df)


@pytest.mark.parametrize("root,project,wsi", [
    ("/data/TCGA", "TCGA-BRCA", "slide.svs"), ("/data/GTEX", "GTEX-LUNG", "GTEX-1.svs"),
    ("/data", "", "a.svs.b")])
def test_slide_h5_path_quirk(root, project, wsi):
    assert tds.slide_h5_path(root, project, wsi) == jds.slide_h5_path(root, project, wsi)


def test_read_ref_file_filters_projects(store, tmp_path):
    _, df = store
    df = df.assign(tcga_project=["AB"[i % 2] for i in range(len(df))])
    path = str(tmp_path / "ref.csv")
    df.to_csv(path, index=False)
    pd.testing.assert_frame_equal(tds.read_ref_file(path, ["B"]),
                                  jds.read_ref_file(path, ["B"]))


@pytest.mark.parametrize("shuffle,batch_size,num_tokens", [(True, 4, None), (False, 5, None),
                                                           (True, 3, 4)])
def test_batch_loader_stream_equals_jax(store, shuffle, batch_size, num_tokens):
    root, df = store
    jl = jds.BatchLoader(jds.FeatureDataset(df, root), batch_size, shuffle=shuffle, seed=3,
                         num_tokens=num_tokens)
    tl = tds.BatchLoader(tds.FeatureDataset(df, root), batch_size, shuffle=shuffle, seed=3,
                         num_tokens=num_tokens)
    for _ in range(2):  # two epochs: the shuffle is drawn per epoch
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == -(-(len(df) - len(BROKEN)) // batch_size)
        for a, b in zip(jb, tb):
            for field in ("features", "rna", "valid"):
                np.testing.assert_array_equal(getattr(b, field), getattr(a, field))
                assert getattr(b, field).dtype == getattr(a, field).dtype
            assert (b.wsi, b.project, b.n_valid) == (a.wsi, a.project, a.n_valid)
    assert tb[-1].n_valid < batch_size and tb[-1].features.shape[0] == batch_size


def test_prefetch_keeps_order_and_transforms(store):
    root, df = store
    d = tds.FeatureDataset(df, root)
    direct = list(tds.BatchLoader(d, 4))
    names = []
    pre = list(tds.prefetch(tds.BatchLoader(d, 4), depth=2,
                            transform=lambda b: (names.append(threading.current_thread().name),
                                                 b)[1]))
    assert len(pre) == len(direct) and threading.main_thread().name not in names
    for a, b in zip(pre, direct):
        np.testing.assert_array_equal(a.features, b.features)


def test_prefetch_propagates_errors():
    def bad():
        yield 1
        raise ValueError("boom")

    it = tds.prefetch(bad())
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_prefetch_exhausted_keeps_raising():
    it = tds.prefetch(iter([1, 2]), depth=2)
    assert list(it) == [1, 2]
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(it)


def test_prefetch_close_unblocks_worker():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = tds.prefetch(endless(), depth=2)
    assert next(it) == 0  # the worker now blocks on the full queue
    it.close()
    assert not it._t.is_alive()
    with pytest.raises(StopIteration):
        next(it)
