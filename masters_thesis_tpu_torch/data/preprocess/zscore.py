"""Beta normalisation: per-session per-voxel z-scoring and repeat averaging.

Reference offline pipeline (AttemptFour/ian_code/nsd_get_data.py:174-281):
per session, betas (V voxels x T trials) are z-scored across the trial axis
(:243-246), then trials of the same NSD image are averaged
(``average_over_conditions``, :527). ThinkAndTell instead normalises with
precomputed per-voxel mean/std over the train set
(ThinkAndTell/load_dataset.py:8-22, data_mean.py). All three transforms here,
vectorised (the reference loops per trial and writes one .npy per trial).

The port's own copy of ``masters_thesis_tpu/data/preprocess/zscore.py``, with the same
names and meaning (``tests/test_torch_ingest.py`` holds the two together).
"""

from __future__ import annotations

import numpy as np


def session_zscore(betas: np.ndarray, axis: int = 0, eps: float = 0.0) -> np.ndarray:
    """z-score across the trial axis of one session.

    betas: (T, V) trials x voxels (axis=0 over trials, matching the
    reference's zscore(axis=1) on its (V, T) layout).
    """
    mean = betas.mean(axis=axis, keepdims=True)
    std = betas.std(axis=axis, keepdims=True)
    std = np.where(std == 0, 1.0, std) + eps
    return ((betas - mean) / std).astype(np.float32)


def average_over_repeats(
    betas: np.ndarray, condition_ids: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Average trials that share a condition (NSD image) id.

    betas: (T, V); condition_ids: (T,). Returns (unique_ids, averaged (U, V)),
    unique ids in first-appearance order (matching per-trial write order).
    """
    condition_ids = np.asarray(condition_ids)
    uniq, first_idx, inverse = np.unique(
        condition_ids, return_index=True, return_inverse=True
    )
    order = np.argsort(first_idx)
    sums = np.zeros((len(uniq), betas.shape[1]), np.float64)
    counts = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inverse, betas)
    np.add.at(counts, inverse, 1)
    avg = (sums / counts[:, None]).astype(np.float32)
    return uniq[order], avg[order]


def voxelwise_stats(betas: np.ndarray,
                    chunk: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Per-voxel mean/std over the full train set (ThinkAndTell/data_mean.py).

    Two chunked passes (mean, then variance) so a memmapped pack streams
    through without materialising the dataset (30k x 327k fp32 is ~40 GB;
    data_mean.py:8-11 notes 78 GB at fp64) — same math as the one-shot
    ``betas.mean/std`` up to summation order.
    """
    n, v = betas.shape[0], betas.shape[1]
    total = np.zeros(v, np.float64)
    for i in range(0, n, chunk):
        total += np.asarray(betas[i:i + chunk], np.float64).sum(axis=0)
    mean = total / n
    sq = np.zeros(v, np.float64)
    for i in range(0, n, chunk):
        d = np.asarray(betas[i:i + chunk], np.float64) - mean
        sq += (d * d).sum(axis=0)
    std = np.sqrt(sq / n)
    std = np.where(std == 0, 1.0, std)
    return mean.astype(np.float32), std.astype(np.float32)
