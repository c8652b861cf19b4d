"""Synthetic fixtures: fake betas with known Glasser-like group structure, a
tiny caption corpus, and key splits.

The port's own copy of the functions of ``masters_thesis_tpu/data/synthetic.py``
that the port uses, with the same names and meaning
(``tests/test_torch_copies.py`` holds them together). One difference:
``synthetic_dataset`` returns the betas as a host array with their keys, and
the caller builds the port's ``data.store.ArrayStore`` on the device it
wants. The structured and compositional modes are not copied.
"""

from __future__ import annotations

import numpy as np

from masters_thesis_tpu_torch.data.pairs import create_pairs
from masters_thesis_tpu_torch.data.splits import KeySplit
from masters_thesis_tpu_torch.data.tokenizer import Tokenizer

_WORDS = (
    "a the man woman dog cat ball red blue small large sitting standing "
    "running holding on in near table chair park beach street food plate "
    "group person people tree sky water grass playing eating walking looking"
).split()


def synthetic_groups(n_voxels: int = 512, n_groups: int = 8, seed: int = 0):
    """Random contiguous-ish voxel index groups with ragged sizes (the Glasser
    atlas yields 360 ragged groups; load_avg_betas.py:59-94)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    cuts = np.sort(rng.choice(np.arange(1, n_voxels), size=n_groups - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n_voxels]])
    return [np.arange(bounds[i], bounds[i + 1]) for i in range(n_groups)]


def synthetic_captions(keys, n_caps: int = 5, seed: int = 0):
    rng = np.random.Generator(np.random.PCG64(seed))
    caps = {}
    for key in keys:
        lines = []
        for _ in range(n_caps):
            n = int(rng.integers(4, 10))
            lines.append(" ".join(rng.choice(_WORDS, size=n)) + ".")
        caps[int(key)] = lines
    return caps


def synthetic_dataset(
    n_keys: int = 32,
    n_voxels: int = 512,
    n_groups: int = 8,
    n_caps: int = 5,
    top_k: int = 60,
    seed: int = 0,
):
    """Returns (split, pairs_by_split, tokenizer, betas, keys, groups):
    ``betas`` (n_keys, n_voxels) float32 on the host, row i of key
    ``keys[i]``; the other items as the JAX package's ``synthetic_dataset``
    returns them, whose store holds the same rows under the same keys."""
    rng = np.random.Generator(np.random.PCG64(seed))
    keys = np.arange(1, n_keys + 1, dtype=np.int64)
    n_tr = int(0.7 * n_keys)
    n_va = int(0.15 * n_keys) or 1
    split = KeySplit(
        train=keys[:n_tr], val=keys[n_tr : n_tr + n_va], test=keys[n_tr + n_va :]
    )
    caps = synthetic_captions(keys, n_caps=n_caps, seed=seed)
    betas = rng.standard_normal((n_keys, n_voxels)).astype(np.float32)
    pairs = {
        name: create_pairs(getattr(split, name), caps)
        for name in ("train", "val", "test")
    }

    tok = Tokenizer(num_words=top_k)
    tok.fit_on_texts([p[1] for p in pairs["train"] + pairs["val"]])
    tok.install_pad()

    groups = synthetic_groups(n_voxels, n_groups, seed=seed)
    return split, pairs, tok, betas, keys, groups
