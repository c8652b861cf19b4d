"""NSD key splits: 9000 subject-unique train keys, 1000 shared keys minus
the 515-key all-subject test set as validation
(AttemptFour/DataLoaders/load_avg_betas.py:199-229), with the CSV schema of
``TrainData/subj0X_conditions.csv`` (columns: nsd_key, is_shared) and
``TrainData/test_conditions.csv`` (column: nsd_key).

The port's own copy of ``masters_thesis_tpu/data/splits.py``, with the same
names and meaning (``tests/test_torch_ingest.py`` holds the two together);
``get_nsd_keys`` splits a real subject's keys for ``experiment.build_data``
and ``run_preprocess`` (ROADMAP M19).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass

import numpy as np


@dataclass
class KeySplit:
    train: np.ndarray  # unique keys (9000 in the reference)
    val: np.ndarray    # shared minus test (485)
    test: np.ndarray   # all-subject shared test keys (515)


def _read_csv(path: str) -> dict[str, list[str]]:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    cols: dict[str, list[str]] = {}
    for row in rows:
        for k, v in row.items():
            cols.setdefault(k, []).append(v)
    return cols


def get_nsd_keys(
    conditions_csv: str, test_csv: str, strict: bool = True
) -> KeySplit:
    """Split keys as the reference does (load_avg_betas.py:214-229).

    strict=True enforces the reference's 9000/1000/515 assertions
    (:221-223); disable for synthetic fixtures.
    """
    cond = _read_csv(conditions_csv)
    test = _read_csv(test_csv)

    nsd_key = np.asarray([int(k) for k in cond["nsd_key"]], dtype=np.int64)
    is_shared = np.asarray([int(s) for s in cond["is_shared"]], dtype=np.int64)
    test_keys = np.asarray([int(k) for k in test["nsd_key"]], dtype=np.int64)

    unq = nsd_key[is_shared == 0]
    shrd = nsd_key[is_shared == 1]

    if strict:
        assert len(unq) == 9000, f"incorrect amount of unq keys: {len(unq)}"
        assert len(shrd) == 1000, f"incorrect amount of shrd keys: {len(shrd)}"
        assert len(test_keys) == 515, f"incorrect amount of test keys: {len(test_keys)}"

    test_set = set(test_keys.tolist())
    shrd = np.asarray([k for k in shrd.tolist() if k not in test_set], dtype=np.int64)
    return KeySplit(train=unq, val=shrd, test=test_keys)


def split_from_keys(
    train: np.ndarray, val: np.ndarray, test: np.ndarray
) -> KeySplit:
    return KeySplit(
        train=np.asarray(train, dtype=np.int64),
        val=np.asarray(val, dtype=np.int64),
        test=np.asarray(test, dtype=np.int64),
    )
