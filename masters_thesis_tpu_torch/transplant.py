"""Move weights between the flax variable tree and a port state dict.

The port's modules are named after the flax tree, so the map is the key
path alone: ``params/attention/W1/kernel`` is ``attention.W1.kernel``, and
``batch_stats/encoder/input_bn/mean`` is the buffer
``encoder.input_bn.mean``. Shapes are identical (a Dense kernel stays
(in, out)). Both directions work on numpy arrays, and a round trip is exact:

    variables = jax.tree_util.tree_map(np.asarray, flax_variables)
    model.load_state_dict(from_flax(variables))

The port itself never imports jax; callers hand it numpy trees.
"""

from __future__ import annotations

import numpy as np
import torch

_COLLECTIONS = ("params", "batch_stats")
# flax BatchNorm's batch_stats leaves; no parameter of the port has these names
_BATCH_STATS_LEAVES = ("mean", "var")


def _flatten(tree: dict, prefix: tuple = ()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of numpy arrays -> state dict."""
    unknown = set(variables) - set(_COLLECTIONS)
    if unknown:
        raise ValueError(f"unexpected flax collections {sorted(unknown)}")
    state = {}
    for collection in _COLLECTIONS:
        for path, value in _flatten(variables.get(collection, {})):
            key = ".".join(path)
            if key in state:
                raise ValueError(f"flax key {key!r} appears twice")
            state[key] = torch.from_numpy(np.array(value, copy=True))
    return state


def to_flax(state_dict: dict) -> dict:
    """State dict -> {'params': ..., 'batch_stats': ...} of numpy arrays."""
    variables: dict = {}
    for key, tensor in state_dict.items():
        path = key.split(".")
        collection = ("batch_stats" if path[-1] in _BATCH_STATS_LEAVES
                      else "params")
        node = variables.setdefault(collection, {})
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = tensor.detach().cpu().numpy().copy()
    return variables
