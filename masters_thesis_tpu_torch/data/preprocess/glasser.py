"""Glasser-atlas group construction.

Reference (AttemptFour/DataLoaders/load_avg_betas.py:34-94): loads
``lh/rh.HCP_MMP1.mgz`` (163,842 fsaverage vertices each, labels 0..180),
builds per-hemisphere vertex-index groups for labels 1..180 (region 0 =
unlabelled, excluded), concatenates LH groups then RH groups -> 360 groups
over the 327,684-vertex full-cortex vector. The visual-cortex mask keeps the
parcels listed in ``visual_parcels_glasser.csv`` (62,756 vertices).

This module takes plain label VECTORS (np arrays); ``load_atlas_vector``
reads .npy directly and .mgh/.mgz through the pure-numpy reader in
``mgh.py`` (no nibabel dependency).

The port's own copy of ``masters_thesis_tpu/data/preprocess/glasser.py``, with the same
names and meaning (``tests/test_torch_ingest.py`` holds the two together).
"""

from __future__ import annotations

import numpy as np


def load_atlas_vector(path: str) -> np.ndarray:
    """Load a per-vertex label vector from .npy or .mgh/.mgz (the pure-numpy
    reader in ``mgh.py`` — load_avg_betas.py:34-50 uses nibabel for the
    same HCP_MMP1.mgz files; no nibabel needed here)."""
    if path.endswith(".npy"):
        return np.load(path).reshape(-1)
    from masters_thesis_tpu_torch.data.preprocess.mgh import read_mgh

    return read_mgh(path).reshape(-1)


def groups_from_atlas(
    lh_labels: np.ndarray, rh_labels: np.ndarray, exclude_zero: bool = True,
    n_labels: int | None = None,
) -> list[np.ndarray]:
    """Per-hemisphere groups, LH first then RH (load_avg_betas.py:59-82).

    RH indices are offset by len(lh_labels) into the concatenated vector.

    ``n_labels`` pins each hemisphere block's size (HCP-MMP1: 180). The
    default sizes each block by the atlas's own max label, which covers
    gaps BELOW the max (absent labels get empty groups, so group index i
    always means label i+1) but not truncation AT THE TOP — and if the two
    hemispheres' maxes differ, the RH block offset shifts relative to the
    canonical 2x180 index space. That case logs a warning; pass
    ``n_labels`` to pin the blocks when index-keyed config
    (groups_to_remove, region names) must stay aligned.
    """
    import logging

    lh_labels = np.asarray(lh_labels).reshape(-1)
    rh_labels = np.asarray(rh_labels).reshape(-1)
    lh_max = int(lh_labels.max()) if lh_labels.size else 0
    rh_max = int(rh_labels.max()) if rh_labels.size else 0
    if n_labels is None and lh_max != rh_max:
        logging.getLogger(__name__).warning(
            "atlas hemispheres carry different label ranges (LH max %d, "
            "RH max %d): the RH group block starts at index %d, not the "
            "canonical per-hemisphere size — index-keyed config "
            "(groups_to_remove, region names) may misalign; pass n_labels "
            "to pin the block size", lh_max, rh_max, lh_max)

    def hemi_groups(labels, offset, hi):
        # fixed label range 1..hi (not sorted(set(...))): group index i
        # must always mean label i+1, or index-keyed config like
        # cfg.groups_to_remove silently shifts to the wrong cortical
        # regions whenever a label is absent from a (masked/partial) atlas
        lo = 0 if not exclude_zero else 1
        out = []
        for lab in range(lo, hi + 1):
            out.append(np.nonzero(labels == lab)[0].astype(np.int64) + offset)
        return out

    return (hemi_groups(lh_labels, 0, n_labels or lh_max)
            + hemi_groups(rh_labels, len(lh_labels), n_labels or rh_max))


def visual_cortex_mask(
    lh_labels: np.ndarray, rh_labels: np.ndarray, visual_parcels
) -> np.ndarray:
    """Indices of vertices whose label is in the visual-parcel list
    (ThinkAndTell/train.py:78-113 semantics on the concatenated vector)."""
    labels = np.concatenate(
        [np.asarray(lh_labels).reshape(-1), np.asarray(rh_labels).reshape(-1)]
    )
    keep = np.isin(labels, np.asarray(list(visual_parcels)))
    return np.nonzero(keep)[0].astype(np.int64)


def select_groups(groups: list[np.ndarray], remove: list[int]) -> list[np.ndarray]:
    """Drop groups by index (load_avg_betas.select_groups :103-114; the
    flagship run removes 15 regions, main.py:115)."""
    rm = set(remove)
    return [g for i, g in enumerate(groups) if i not in rm]
