"""Port data/splits.py (no sklearn) against the JAX package's, which calls
sklearn's ``KFold`` and ``train_test_split``: the fold arrays must be equal."""

import numpy as np
import pytest

from sequoia_tpu.data import splits as jsplits
from sequoia_tpu_torch.data import splits as tsplits

# (unique patients, rows, n_splits, random_state, valid_size)
CASES = [(7, 20, 3, 0, 0.1), (30, 30, 5, 0, 0.1), (40, 80, 5, 7, 0.1),
         (23, 50, 4, 3, 0.2), (11, 11, 2, 0, 0.0), (100, 157, 5, 99, 0.25),
         (10, 25, 10, 1, 0.3), (64, 64, 5, 0, 3)]


def _ids(patients, rows, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.asarray([f"TCGA-{i:04d}" for i in range(patients)])
    return np.concatenate([ids, rng.choice(ids, rows - patients)])[rng.permutation(rows)]


@pytest.mark.parametrize("patients,rows,n_splits,seed,valid_size", CASES)
def test_patient_kfold_equals_sklearn(patients, rows, n_splits, seed, valid_size):
    ids = _ids(patients, rows, seed)
    want = jsplits.patient_kfold(ids, n_splits=n_splits, random_state=seed,
                                 valid_size=valid_size)
    got = tsplits.patient_kfold(ids, n_splits=n_splits, random_state=seed,
                                valid_size=valid_size)
    for w_part, g_part in zip(want, got, strict=True):
        assert len(w_part) == len(g_part)
        for w, g in zip(w_part, g_part):
            np.testing.assert_array_equal(g, w)


def test_seed_reaches_both_draws():
    ids = _ids(30, 30)
    _, va0, te0 = tsplits.patient_kfold(ids, n_splits=3, random_state=0)
    _, va1, te1 = tsplits.patient_kfold(ids, n_splits=3, random_state=7)
    assert not all(np.array_equal(a, b) for a, b in zip(te0, te1))
    assert not all(np.array_equal(a, b) for a, b in zip(va0, va1))


@pytest.mark.parametrize("seed", [0, 5])
def test_patient_split_equals_sklearn(seed):
    ids = _ids(37, 60, seed)
    for w, g in zip(jsplits.patient_split(ids, seed), tsplits.patient_split(ids, seed),
                    strict=True):
        np.testing.assert_array_equal(g, w)


def test_too_many_splits_raise_like_sklearn():
    ids = _ids(3, 5)
    with pytest.raises(ValueError):
        jsplits.patient_kfold(ids, n_splits=4)
    with pytest.raises(ValueError):
        tsplits.patient_kfold(ids, n_splits=4)


def test_match_patient_split_and_kfold():
    ids = _ids(20, 45, 2)
    folds = [(ids[:10], ids[10:13], ids[13:20]), (ids[5:15], ids[15:16], ids[:5])]
    for w, g in zip(jsplits.match_patient_kfold(ids, folds),
                    tsplits.match_patient_kfold(ids, folds), strict=True):
        for a, b in zip(w, g, strict=True):
            np.testing.assert_array_equal(b, a)
    for a, b in zip(jsplits.match_patient_split(ids, folds[0]),
                    tsplits.match_patient_split(ids, folds[0]), strict=True):
        np.testing.assert_array_equal(b, a)


def test_load_shipped_patient_splits_round_trip(tmp_path):
    ids = _ids(15, 30, 4)
    tr, va, te = jsplits.patient_kfold(ids, n_splits=3)
    art = {f"fold_{i}": {"train": np.unique(ids[a]), "val": np.unique(ids[b]),
                         "test": np.unique(ids[c])}
           for i, (a, b, c) in enumerate(zip(tr, va, te))}
    art["meta"] = "not a fold"
    path = tmp_path / "TCGA-TEST.npy"
    np.save(path, art, allow_pickle=True)
    want = jsplits.load_shipped_patient_splits(str(path))
    got = tsplits.load_shipped_patient_splits(str(path))
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        for a, b in zip(w, g, strict=True):
            np.testing.assert_array_equal(b, a)
    # the loaded triples recover the original fold rows
    for got_part, orig in zip(tsplits.match_patient_kfold(ids, got), (tr, va, te)):
        for a, b in zip(got_part, orig):
            np.testing.assert_array_equal(a, b)


def test_filter_by_test_wsis(tmp_path):
    import pandas as pd
    import pickle

    df = pd.DataFrame({"wsi_file_name": [f"s{i}.svs" for i in range(6)], "x": range(6)})
    art = {"brca": {"split_1": ["s1.svs", "s4.svs"], 0: ["s0.svs"]}}
    path = tmp_path / "test_wsis.pkl"
    with open(path, "wb") as f:
        pickle.dump(art, f)
    loaded = tsplits.load_test_wsis(str(path))
    assert loaded == jsplits.load_test_wsis(str(path))
    for split in (1, 0, "split_1"):
        pd.testing.assert_frame_equal(tsplits.filter_by_test_wsis(df, loaded, "brca", split),
                                      jsplits.filter_by_test_wsis(df, loaded, "brca", split))
