"""Patient-level cross-validation splits, equal to the reference's.

Counterpart of ``sequoia_tpu/data/splits.py``.  Contract (reference
``src/utils.py:44-110``): folds are drawn over the *unique patient ids* with
sklearn's ``KFold(n_splits, shuffle=True, random_state)``; each fold's train
patients give up ``valid_size`` of themselves to validation through
``train_test_split(test_size=valid_size, random_state)``; row indices follow
from patient membership.

The port uses no sklearn (the GPU machine has none).  It keeps its own numpy
copy of the two draws, as sklearn makes them:

* ``KFold``: one ``RandomState(random_state).shuffle`` of ``arange(n)``,
  then folds of ``n // k`` in that order, the first ``n % k`` folds one
  larger; each fold's test and train indices come back sorted;
* ``train_test_split``: a fresh ``RandomState(random_state).permutation(n)``
  with ``n_test = ceil(test_size * n)``: the test part first, the train part
  the next ``n - n_test``.
"""

from __future__ import annotations

import math
import numbers

import numpy as np


def _kfold(n: int, n_splits: int, random_state):
    """``KFold(n_splits, shuffle=True, random_state).split(arange(n))``:
    (train, test) index pairs, each sorted."""
    if n_splits < 2:
        raise ValueError(f"k-fold cross-validation needs n_splits >= 2, got {n_splits}")
    if n_splits > n:
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater "
                         f"than the number of samples: n_samples={n}.")
    order = np.arange(n)
    np.random.RandomState(random_state).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[order[start:start + size]] = True
        start += size
        yield np.flatnonzero(~test), np.flatnonzero(test)


def _train_test_split(a, test_size, random_state):
    """``train_test_split(a, test_size=test_size, random_state=...)`` ->
    (train, test)."""
    a = np.asarray(a)
    n = len(a)
    if isinstance(test_size, numbers.Integral):
        n_test = int(test_size)
    elif 0 < test_size < 1:
        n_test = math.ceil(test_size * n)
    else:
        raise ValueError(f"test_size={test_size} should be a float in (0, 1) or an int")
    n_train = n - n_test
    if n_train <= 0 or n_test > n:
        raise ValueError(f"With n_samples={n}, test_size={test_size} the train set "
                         "would be empty")
    perm = np.random.RandomState(random_state).permutation(n)
    return a[perm[n_test:n_test + n_train]], a[perm[:n_test]]


def patient_kfold(patient_ids, n_splits: int = 5, random_state: int = 0,
                  valid_size: float = 0.1):
    """(train_idx, valid_idx, test_idx): lists of row-index arrays, one per
    fold, equal to the reference ``patient_kfold``'s.  ``random_state``
    seeds both draws."""
    patient_ids = np.asarray(patient_ids)
    indices = np.arange(len(patient_ids))
    patients_unique = np.unique(patient_ids)

    train_idx, valid_idx, test_idx = [], [], []
    for ind_train, ind_test in _kfold(len(patients_unique), n_splits, random_state):
        patients_train = patients_unique[ind_train]
        patients_test = patients_unique[ind_test]

        test_idx.append(indices[np.isin(patient_ids, patients_test)])
        if valid_size > 0:
            patients_train, patients_valid = _train_test_split(
                patients_train, valid_size, random_state)
            valid_idx.append(indices[np.isin(patient_ids, patients_valid)])
        train_idx.append(indices[np.isin(patient_ids, patients_train)])

    return train_idx, valid_idx, test_idx


def patient_split(patient_ids, random_state: int = 0):
    """One 64/16/20 patient split (reference ``patient_split``)."""
    patient_ids = np.asarray(patient_ids)
    patients_train, patients_test = _train_test_split(np.unique(patient_ids), 0.2,
                                                      random_state)
    patients_train, patients_val = _train_test_split(patients_train, 0.2, random_state)
    indices = np.arange(len(patient_ids))
    return (indices[np.isin(patient_ids, patients_train)],
            indices[np.isin(patient_ids, patients_val)],
            indices[np.isin(patient_ids, patients_test)])


def match_patient_split(patient_ids, split):
    """Row indices from a saved (train, valid, test) patient-id triple
    (reference ``match_patient_split``)."""
    patient_ids = np.asarray(patient_ids)
    indices = np.arange(len(patient_ids))
    return tuple(indices[np.isin(patient_ids, part)] for part in split)


def match_patient_kfold(patient_ids, splits):
    """Per-fold row indices from saved patient-id triples (reference
    ``match_patient_kfold``), the path of the shipped ``patient_splits.zip``."""
    patient_ids = np.asarray(patient_ids)
    indices = np.arange(len(patient_ids))
    train_idx, valid_idx, test_idx = [], [], []
    for train_patients, valid_patients, test_patients in splits:
        train_idx.append(indices[np.isin(patient_ids, train_patients)])
        valid_idx.append(indices[np.isin(patient_ids, valid_patients)])
        test_idx.append(indices[np.isin(patient_ids, test_patients)])
    return train_idx, valid_idx, test_idx


def ensure_legacy_pandas_unpickle() -> None:
    """Let pandas >= 2 unpickle pandas-1.x artifacts: the shipped
    ``patient_splits.zip`` arrays pickle ``Int64Index`` objects of the
    removed ``pandas.core.indexes.numeric``; alias its classes to
    ``pd.Index``."""
    import sys
    import types

    import pandas as pd

    name = "pandas.core.indexes.numeric"
    if name in sys.modules or hasattr(getattr(pd.core.indexes, "numeric", None), "Int64Index"):
        return
    mod = types.ModuleType(name)
    mod.Int64Index = mod.Float64Index = mod.UInt64Index = pd.Index
    sys.modules[name] = mod


def load_shipped_patient_splits(path):
    """A reference ``TCGA-{CANCER}.npy`` split artifact (``fold_i -> {train,
    val, test}`` patient ids) -> ``match_patient_kfold``'s input."""
    ensure_legacy_pandas_unpickle()
    obj = np.load(path, allow_pickle=True).item()
    # the fold keys actually present: len(obj) would misalign on 1-indexed
    # folds or extra metadata keys
    fold_keys = sorted((k for k in obj if isinstance(k, str) and k.startswith("fold_")),
                       key=lambda k: int(k.split("_")[1]))
    if not fold_keys:  # an integer-keyed artifact
        fold_keys = sorted(k for k in obj if isinstance(k, int))
    return [(np.asarray(obj[k]["train"]), np.asarray(obj[k]["val"]),
             np.asarray(obj[k]["test"])) for k in fold_keys]


def load_test_wsis(path):
    """The reference's ``test_wsis.pkl`` artifact (``{cancer: {split_i: [wsi
    ids]}}``), unchanged."""
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


def filter_by_test_wsis(df, test_wsis, cancer: str, split: int | str):
    """The rows of ``df`` whose ``wsi_file_name`` is in the artifact's
    ``{cancer}/{split}`` test list."""
    key = split if split in test_wsis.get(cancer, {}) else f"split_{split}"
    wanted = set(map(str, test_wsis[cancer][key]))
    keep = df["wsi_file_name"].astype(str).isin(wanted)
    return df[keep].reset_index(drop=True)
