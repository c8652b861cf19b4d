"""Bucketed block-dense layout for ragged voxel groups.

The port's own copy of ``masters_thesis_tpu/ops/group_layout.py``, with the
same names and meaning (``tests/test_torch_copies.py`` holds the two
together). ``BUCKET_LADDER`` fixes the encoder's parameter shapes, so the
two copies must not drift apart.

The reference's "LocallyDense" brain encoder is 345-360 parallel Keras Dense
layers, one per Glasser region, each applied to ``tf.gather(x, idx)`` in a
Python list comprehension (reference: AttemptFour/Model/layers.py:43-52).
Group sizes are ragged (~50..6000 vertices; load_avg_betas.py:77-80), which on
TPU would either mean hundreds of tiny kernels or one huge padded einsum.

Here groups are bucketed by padded size (a geometric ladder of multiples of
the 128-lane width), giving a handful of dense batched matmuls

    x[B, G_b, P_b] @ W_b[G_b, P_b, D]  ->  out[B, G_b, D]

that XLA maps straight onto the MXU. Gather indices are static int32 arrays;
padding slots point at a zero column appended to the input, so padded lanes
contribute exactly 0 and numerical parity with the ragged reference holds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BUCKET_LADDER = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def _padded_size(n: int, ladder=BUCKET_LADDER) -> int:
    for b in ladder:
        if n <= b:
            return b
    # beyond the ladder: round up to a multiple of the largest rung
    top = ladder[-1]
    return -(-n // top) * top


@dataclass(frozen=True)
class Bucket:
    padded: int            # padded group width P_b
    group_ids: np.ndarray  # (G_b,) original group positions
    indices: np.ndarray    # (G_b, P_b) int32 gather indices (pad -> n_voxels)
    sizes: np.ndarray      # (G_b,) true group sizes


class GroupLayout:
    """Static bucketed layout for a list of ragged index groups."""

    def __init__(self, groups, n_voxels: int, ladder=BUCKET_LADDER):
        self.n_voxels = int(n_voxels)
        self.n_groups = len(groups)
        self.group_sizes = np.asarray([len(g) for g in groups], dtype=np.int32)

        by_pad: dict[int, list[int]] = {}
        for gid, g in enumerate(groups):
            by_pad.setdefault(_padded_size(len(g), ladder), []).append(gid)

        self.buckets: list[Bucket] = []
        for padded in sorted(by_pad):
            gids = np.asarray(by_pad[padded], dtype=np.int32)
            idx = np.full((len(gids), padded), self.n_voxels, dtype=np.int32)
            sizes = np.empty(len(gids), dtype=np.int32)
            for row, gid in enumerate(gids):
                g = np.asarray(groups[gid], dtype=np.int32)
                idx[row, : len(g)] = g
                sizes[row] = len(g)
            self.buckets.append(
                Bucket(padded=padded, group_ids=gids, indices=idx, sizes=sizes)
            )

        # permutation taking bucket-concatenated group order -> original order
        order = np.concatenate([b.group_ids for b in self.buckets])
        self.unpermute = np.argsort(order).astype(np.int32)

    @property
    def padded_total(self) -> int:
        return int(sum(b.padded * len(b.group_ids) for b in self.buckets))

    @property
    def bucket_offsets(self) -> list[int]:
        """Start offset of each bucket's segment in the grouped layout."""
        offs, acc = [], 0
        for b in self.buckets:
            offs.append(acc)
            acc += b.padded * len(b.group_ids)
        return offs

    def flat_indices(self) -> np.ndarray:
        """(padded_total,) gather indices into the zero-padded input
        (index n_voxels = the zero slot)."""
        return np.concatenate([b.indices.reshape(-1) for b in self.buckets])

    def permute_rows(self, data: np.ndarray) -> np.ndarray:
        """Pre-gather rows into the grouped padded layout (N, padded_total).

        Doing this ONCE at preprocessing time removes the per-step voxel
        gather from the training hot path entirely — batches then slice
        contiguous bucket segments (see LocallyDense(pregathered=True)).
        """
        data = np.asarray(data)
        padded = np.pad(data, ((0, 0), (0, 1)))
        return padded[:, self.flat_indices()]

    # ---- persistence (run-dir artefact so models can be rebuilt) ----
    def save(self, path: str) -> None:
        groups = self.to_groups()
        flat = np.concatenate(groups) if groups else np.zeros(0, np.int64)
        offsets = np.cumsum([0] + [len(g) for g in groups])
        np.savez(path, flat=flat, offsets=offsets, n_voxels=self.n_voxels)

    @classmethod
    def load(cls, path: str) -> "GroupLayout":
        z = np.load(path)
        flat, offsets = z["flat"], z["offsets"]
        groups = [
            flat[offsets[i] : offsets[i + 1]] for i in range(len(offsets) - 1)
        ]
        return cls(groups, int(z["n_voxels"]))

    def to_groups(self) -> list[np.ndarray]:
        """Recover the original ragged groups in original order."""
        out: dict[int, np.ndarray] = {}
        for b in self.buckets:
            for row, gid in enumerate(b.group_ids):
                out[int(gid)] = b.indices[row, : b.sizes[row]].astype(np.int64)
        return [out[i] for i in range(self.n_groups)]
