"""The Glasser-like atlas of the LcNIC configurations: which voxels form
each group, and which groups share one clipped encoder tensor.

The atlas is part of a configuration, fixed by its ``atlas_seed``, not by
a run's seed: a frozen copy of the rule of
``masters_thesis_tpu_torch/data/synthetic.py::synthetic_groups`` (contiguous
groups between sorted random cuts), which gives the flagship store of the
repo's chip records (about 472,600 padded columns a row).
"""

from __future__ import annotations

import numpy as np

# the encoder's bucket widths: groups padded to the same width share one
# kernel tensor, and Keras' clipnorm clips each tensor by its own norm
BUCKET_LADDER = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def group_bounds(cfg: dict) -> np.ndarray:
    """(n_groups + 1,) voxel bounds: group g is [bounds[g], bounds[g+1])."""
    n, g = cfg["n_voxels"], cfg["n_groups"]
    rng = np.random.Generator(np.random.PCG64(cfg["atlas_seed"]))
    cuts = np.sort(rng.choice(np.arange(1, n), size=g - 1, replace=False))
    return np.concatenate([[0], cuts, [n]]).astype(np.int64)


def group_sizes(cfg: dict) -> np.ndarray:
    return np.diff(group_bounds(cfg))


def padded_width(size: int) -> int:
    """The bucket width a group of ``size`` voxels is padded to."""
    for width in BUCKET_LADDER:
        if size <= width:
            return width
    top = BUCKET_LADDER[-1]
    return -(-size // top) * top


def group_widths(cfg: dict) -> np.ndarray:
    """(n_groups,) the padded width of each group's bucket."""
    return np.asarray([padded_width(int(s)) for s in group_sizes(cfg)])


def padded_total(cfg: dict) -> int:
    """Columns of one pregathered row: every group at its bucket's width."""
    return int(group_widths(cfg).sum())
