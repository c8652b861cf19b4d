"""NSD stimulus images: the nsd_stimuli.hdf5 ``imgBrick`` reader.

The reference reaches stimulus pixels through NSDAccess.read_images
(AttemptFour/metric_suit.py:75-80 constructs NSDAccess;
Eval/sample_captions.py and soloist's TensorBoardCaption render captions on
them). NSDAccess opens ``nsd_stimuli.hdf5`` whose ``imgBrick`` dataset is
(73000, 425, 425, 3) uint8, row i = NSD key i+1 (keys are 1-based
throughout the reference, metric_suit.py:76).

This module reads the brick directly with h5py — rows on demand, no
full-brick materialisation — and exports per-key ``KID{key}.png`` files
(the layout ``dataset.images_path`` previews and ``load_stimulus_images``
consume).

The port's own copy of ``masters_thesis_tpu/data/nsd_images.py``, with the same
names and meaning (``tests/test_torch_ingest.py`` holds the two together).
"""

from __future__ import annotations

import os

import numpy as np

DATASET = "imgBrick"


def read_stimuli(path: str, keys=None, dataset: str = DATASET) -> np.ndarray:
    """Read stimulus images for 1-based NSD ``keys`` (all rows when None).

    Returns (N, H, W, 3) uint8. Rows are fetched through h5py's lazy
    indexing — only the requested keys are read from disk."""
    import h5py

    with h5py.File(path, "r") as f:
        brick = f[dataset]
        if keys is None:
            return np.asarray(brick[()])
        keys = np.asarray(list(keys), dtype=np.int64)
        if keys.size == 0:
            return np.zeros((0,) + brick.shape[1:], dtype=brick.dtype)
        if keys.min() < 1 or keys.max() > brick.shape[0]:
            raise ValueError(
                f"NSD keys must be in [1, {brick.shape[0]}], "
                f"got [{keys.min()}, {keys.max()}]")
        rows = keys - 1
        # h5py fancy indexing needs sorted unique indices; restore order after
        uniq, inv = np.unique(rows, return_inverse=True)
        return np.asarray(brick[uniq])[inv]


def iter_stimuli_chunks(path: str, keys=None, chunk: int = 256,
                        dataset: str = DATASET):
    """Yield (keys_chunk, images_chunk) without holding the whole brick."""
    import h5py

    with h5py.File(path, "r") as f:
        brick = f[dataset]
        if keys is None:
            keys = np.arange(1, brick.shape[0] + 1, dtype=np.int64)
        else:
            keys = np.asarray(list(keys), dtype=np.int64)
            if len(keys) and (keys.min() < 1 or keys.max() > brick.shape[0]):
                raise ValueError(
                    f"NSD keys must be in [1, {brick.shape[0]}], "
                    f"got [{keys.min()}, {keys.max()}]")
        for i in range(0, len(keys), chunk):
            ck = keys[i:i + chunk]
            rows = ck - 1
            uniq, inv = np.unique(rows, return_inverse=True)
            yield ck, np.asarray(brick[uniq])[inv]


def export_images(path: str, keys, out_dir: str, fmt: str = "png") -> int:
    """Write ``KID{key}.{fmt}`` files for the given NSD keys; returns the
    count. ``fmt='npy'`` writes raw arrays (no PIL needed)."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for ck, imgs in iter_stimuli_chunks(path, keys):
        for key, img in zip(ck, imgs):
            out = os.path.join(out_dir, f"KID{int(key)}.{fmt}")
            if fmt == "npy":
                np.save(out, img)
            else:
                from PIL import Image

                Image.fromarray(np.asarray(img, np.uint8)).save(out)
            n += 1
    return n
