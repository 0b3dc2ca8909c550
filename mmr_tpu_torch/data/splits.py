"""Dataset split management (counterpart of ``mmr_tpu/data/splits.py``),
the semantics of ``Pre_Process.py:95-275``, without scikit-learn:

- ``train-val-test``: 70/10/20 by two ``train_test_split`` passes
  (``test_size=0.2``, then ``0.125`` of the rest), seed 12345, written
  once to ``<dataset>/train_val_test_split.json``;
- ``5-fold``: ``KFold(5, shuffle=True, random_state=seed)``, written once
  to ``<dataset>/crossval_split.json``.

:func:`train_test_split` and :func:`kfold_indices` draw what scikit-learn's
``ShuffleSplit`` and ``KFold`` draw from ``np.random.RandomState(seed)``,
and raise ``ValueError`` where they raise, so the files are byte-equal to
the JAX package's.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from mmr_tpu_torch.data.zarr_io import list_dataset_stores

DEFAULT_SEED = 12345


def train_test_split(items: list, test_size: float, random_state: int):
    """(train, test) lists of ``items``: ``ShuffleSplit``'s one split —
    ``n_test = ceil(test_size · n)``, ``perm = RandomState(seed).permutation(n)``,
    test ``perm[:n_test]``, train ``perm[n_test:]``, in permuted order."""
    n = len(items)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train <= 0:
        raise ValueError(
            f"With n_samples={n}, test_size={test_size} and train_size=None, "
            "the resulting train set will be empty. Adjust any of the "
            "aforementioned parameters.")
    perm = np.random.RandomState(random_state).permutation(n)
    return ([items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]])


def kfold_indices(n: int, n_splits: int, random_state: int):
    """``KFold(n_splits, shuffle=True, random_state).split`` over ``n``
    samples: (train, val) index arrays a fold, both ascending. ``arange(n)``
    is shuffled once; fold ``k`` holds the next ``n // n_splits`` of it,
    one more for the first ``n % n_splits`` folds."""
    if n_splits > n:
        raise ValueError(
            f"Cannot have number of splits n_splits={n_splits} greater than "
            f"the number of samples: n_samples={n}.")
    order = np.arange(n)
    np.random.RandomState(random_state).shuffle(order)
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    start = 0
    for size in sizes:
        val = np.zeros(n, bool)
        val[order[start:start + size]] = True
        start += size
        yield np.flatnonzero(~val), np.flatnonzero(val)


def generate_crossval_split(identifiers: list[str], seed: int = DEFAULT_SEED,
                            n_splits: int = 5) -> list[dict]:
    return [{"train": [identifiers[i] for i in train],
             "val": [identifiers[i] for i in val]}
            for train, val in kfold_indices(len(identifiers), n_splits, seed)]


def create_split_files(dataset_path: str | Path, splitting: str,
                       seed: int = DEFAULT_SEED) -> Path:
    dataset_path = Path(dataset_path)
    identifiers = sorted(p.name.replace(".zarr", "") for p in list_dataset_stores(dataset_path))
    if not identifiers:
        raise FileNotFoundError(f"no .zarr stores under {dataset_path}")

    if splitting == "train-val-test":
        out = dataset_path / "train_val_test_split.json"
        if out.exists():
            return out
        trainval, test = train_test_split(identifiers, test_size=0.2, random_state=seed)
        train, val = train_test_split(trainval, test_size=0.125, random_state=seed)
        out.write_text(json.dumps({"train": train, "val": val, "test": test}, indent=2))
    elif splitting == "5-fold":
        out = dataset_path / "crossval_split.json"
        if out.exists():
            return out
        out.write_text(json.dumps(generate_crossval_split(identifiers, seed), indent=2))
    else:
        raise ValueError(f"splitting must be 'train-val-test' or '5-fold', got {splitting!r}")
    return out


def get_data_ids(dataset_path: str | Path, splitting: str, section: str,
                 fold: int | None = None) -> list[str]:
    """ids for ``section`` in {'train','val','test'} (``Pre_Process.py:214-275``)."""
    dataset_path = Path(dataset_path)
    if splitting == "train-val-test":
        data = json.loads((dataset_path / "train_val_test_split.json").read_text())
        return data[section]
    if splitting == "5-fold":
        folds = json.loads((dataset_path / "crossval_split.json").read_text())
        if fold is None:
            raise ValueError("fold required for 5-fold splitting")
        if section == "test":
            return folds[fold]["val"]
        return folds[fold][section]
    raise ValueError(f"unknown splitting {splitting!r}")
