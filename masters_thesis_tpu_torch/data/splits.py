"""NSD key splits: 9000 subject-unique train keys, 1000 shared keys minus
the 515-key all-subject test set as validation
(AttemptFour/DataLoaders/load_avg_betas.py:199-229).

The port's own copy of ``KeySplit`` from ``masters_thesis_tpu/data/splits.py``;
the CSV split ``get_nsd_keys`` comes with the real-data path (ROADMAP M10).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class KeySplit:
    train: np.ndarray  # unique keys (9000 in the reference)
    val: np.ndarray    # shared minus test (485)
    test: np.ndarray   # all-subject shared test keys (515)
