"""Model summary text: the reference snapshots model.summary() into the run
dir as modelsummary.txt (Callbacks/EpochLoss.py:12-52). Here: a
parameter-tree table with shapes, counts and bytes.

Counterpart of ``masters_thesis_tpu/utils/summary.py``: the same table, row
for row, from the flax variable tree that ``transplant.to_flax`` makes of a
port model's state dict, walked in the order ``jax.tree_util`` walks a dict
(keys sorted at every level).
"""

from __future__ import annotations

import numpy as np


def _flatten_sorted(tree: dict, prefix: tuple = ()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _flatten_sorted(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def model_summary(params, batch_stats=None, name: str = "model") -> str:
    rows = []

    def collect(tree, kind):
        for path, leaf in _flatten_sorted(tree):
            arr = np.asarray(leaf)
            rows.append(("/".join(path), kind, tuple(arr.shape), arr.size,
                         arr.size * arr.dtype.itemsize, str(arr.dtype)))

    collect(params, "param")
    if batch_stats:
        collect(batch_stats, "stat")

    width = max((len(r[0]) for r in rows), default=10) + 2
    lines = [f"Model: {name}", "=" * (width + 44),
             f"{'name':<{width}}{'kind':<7}{'shape':<20}{'params':>12}"]
    lines.append("-" * (width + 44))
    total = trainable = 0
    for p, kind, shape, size, nbytes, dtype in rows:
        lines.append(f"{p:<{width}}{kind:<7}{str(shape):<20}{size:>12,}")
        total += size
        if kind == "param":
            trainable += size
    lines.append("=" * (width + 44))
    lines.append(f"Total params: {total:,} "
                 f"({sum(r[4] for r in rows) / 1e6:.1f} MB)")
    lines.append(f"Trainable params: {trainable:,}")
    lines.append(f"Non-trainable (batch stats): {total - trainable:,}")
    return "\n".join(lines) + "\n"
