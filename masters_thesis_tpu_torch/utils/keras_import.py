"""Import reference Keras ``save_weights`` .h5 checkpoints into our params.

The reference saves weights-only h5 files (ModelCheckpoint,
AttemptFour/main.py:167-190) and reloads them with
``load_weights(by_name=True, skip_mismatch=True)`` (eval.py:140). This module
maps such a checkpoint onto the TPU framework's LcNIC parameter tree so
reference-trained weights can be evaluated here for seed-fixed caption parity.

Keras h5 layout: layer groups with a ``weight_names`` attr, datasets named
e.g. ``lstm/lstm_cell/kernel:0``. Mapping rules (lc_NIC.py:84-159):

- ``emb_text`` embeddings                 -> params['embedding']
- ``lstm`` kernel/recurrent_kernel/bias   -> params['lstm'][...]  (same
  [i|f|c|o] gate packing as Keras — KerasLSTMCell replicates it)
- attention sub-Denses in creation order  -> attention W1, W2, V
- ``time_distributed_nonlinear``/``_softmax`` -> dense_inter / dense_out
- LocallyDense per-group Denses (creation order == group order) scattered
  into the bucketed kernels (kernel_b[row, :group_size])

The port's own copy of ``masters_thesis_tpu/utils/keras_import.py``, with
the same names and meaning (``tests/test_torch_keras_import.py`` holds the
two together). It fills the same flax-path dict; the port's ``LcNIC`` takes
it through ``transplant.from_flax``::

    params = import_lc_nic_h5(path, to_flax(model.state_dict())["params"],
                              layout)
    model.load_state_dict(from_flax({"params": params, "batch_stats": ...}))

``h5py`` is imported inside ``read_h5_weights`` only: importing the port
does not need it.
"""

from __future__ import annotations

import re

import numpy as np


def read_h5_weights(path: str) -> dict[str, np.ndarray]:
    """Flatten an h5 weights file to {path: array} (':0' suffixes stripped)."""
    import h5py

    out: dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name.removesuffix(":0")] = np.asarray(obj)

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        root.visititems(visit)
    return out


def _numeric_suffix(name: str) -> int:
    m = re.search(r"_(\d+)$", name)
    return int(m.group(1)) if m else 0


def _find(flat: dict, *substrings: str) -> list[str]:
    keys = [k for k in flat if all(s in k for s in substrings)]
    return sorted(keys)


def import_lc_nic_h5(path: str, params: dict, layout) -> dict:
    """Returns a new params dict with every mappable reference weight
    replaced. Raises KeyError with a summary if core weights are missing."""
    flat = read_h5_weights(path)
    new = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}

    def want(candidates: list[str], what: str) -> np.ndarray:
        if not candidates:
            raise KeyError(f"no weight found for {what}; have {sorted(flat)[:10]}…")
        return flat[candidates[0]]

    # embedding
    emb = _find(flat, "emb_text", "embeddings")
    new["embedding"] = np.asarray(want(emb, "embedding"))

    # lstm (kernel (in,4U), recurrent (U,4U), bias (4U,)) — identical packing
    new["lstm"] = {
        "kernel": want(_find(flat, "lstm", "kernel")
                       and [k for k in _find(flat, "lstm", "kernel")
                            if "recurrent" not in k], "lstm kernel"),
        "recurrent_kernel": want(_find(flat, "lstm", "recurrent_kernel"),
                                 "lstm recurrent"),
        "bias": want(_find(flat, "lstm", "bias"), "lstm bias"),
    }

    # output heads
    new["dense_inter"] = {
        "kernel": want(_find(flat, "time_distributed_nonlinear", "kernel"),
                       "dense_inter kernel"),
        "bias": want(_find(flat, "time_distributed_nonlinear", "bias"),
                     "dense_inter bias"),
    }
    new["dense_out"] = {
        "kernel": want(_find(flat, "time_distributed_softmax", "kernel"),
                       "dense_out kernel"),
        "bias": want(_find(flat, "time_distributed_softmax", "bias"),
                     "dense_out bias"),
    }

    # attention: W1, W2, V are its sub-Denses in creation order
    attn_kernels = sorted(
        (k for k in flat if "attention" in k and k.endswith("kernel")),
        key=lambda k: _numeric_suffix(k.rsplit("/", 2)[-2]),
    )
    attn_biases = sorted(
        (k for k in flat if "attention" in k and k.endswith("bias")),
        key=lambda k: _numeric_suffix(k.rsplit("/", 2)[-2]),
    )
    # LcNIC always carries Bahdanau attention — fewer than 3 kernels means
    # the h5 layout wasn't understood, and loading would leave attention at
    # random init while every other block imports (silently wrong captions
    # in the very parity eval this importer exists for)
    if len(attn_kernels) < 3 or len(attn_biases) < 3:
        raise KeyError(
            f"attention weights not found in h5 (kernels={attn_kernels}, "
            f"biases={attn_biases}); expected >=3 'attention*' sub-Denses "
            "(W1, W2, V)")
    new["attention"] = {
        "W1": {"kernel": flat[attn_kernels[0]], "bias": flat[attn_biases[0]]},
        "W2": {"kernel": flat[attn_kernels[1]], "bias": flat[attn_biases[1]]},
        "V": {"kernel": flat[attn_kernels[2]], "bias": flat[attn_biases[2]]},
    }

    # LocallyDense: per-group Denses in creation order == layout group order
    ld_kernels = sorted(
        (k for k in flat
         if ("locally_dense" in k or "lc_dense" in k) and k.endswith("kernel")),
        key=lambda k: _numeric_suffix(k.rsplit("/", 2)[-2]),
    )
    ld_biases = sorted(
        (k for k in flat
         if ("locally_dense" in k or "lc_dense" in k) and k.endswith("bias")),
        key=lambda k: _numeric_suffix(k.rsplit("/", 2)[-2]),
    )
    if ld_kernels:
        assert len(ld_kernels) == layout.n_groups, (
            f"{len(ld_kernels)} per-group kernels vs {layout.n_groups} groups"
        )
        enc = {k: np.asarray(v) for k, v in params["encoder"].items()
               if k.startswith("kernel") or k.startswith("bias")}
        # start from zeros so padded slots stay zero
        enc = {k: (np.zeros_like(v) if k.startswith("kernel") else np.array(v))
               for k, v in enc.items()}
        for b, bucket in enumerate(layout.buckets):
            for row, gid in enumerate(bucket.group_ids):
                kref = np.asarray(flat[ld_kernels[gid]])
                bref = np.asarray(flat[ld_biases[gid]])
                enc[f"kernel_{b}"][row, : kref.shape[0], :] = kref
                enc[f"bias_{b}"][row] = bref
        new_enc = dict(params["encoder"])
        new_enc.update(enc)
        # BatchNorm of the encoder (input_bn): gamma/beta
        bn_g = _find(flat, "input_bn", "gamma")
        bn_b = _find(flat, "input_bn", "beta")
        if bn_g and "input_bn" in new_enc:
            new_enc["input_bn"] = {
                "scale": np.asarray(flat[bn_g[0]]),
                "bias": np.asarray(flat[bn_b[0]]),
            }
        new["encoder"] = new_enc

    return new


def import_bn_stats_h5(path: str, batch_stats: dict) -> dict:
    """Moving mean/variance of the encoder BatchNorm -> batch_stats."""
    flat = read_h5_weights(path)
    mm = _find(flat, "input_bn", "moving_mean")
    mv = _find(flat, "input_bn", "moving_variance")
    if not mm:
        return batch_stats
    new = dict(batch_stats)
    enc = dict(new.get("encoder", {}))
    enc["input_bn"] = {
        "mean": np.asarray(flat[mm[0]]),
        "var": np.asarray(flat[mv[0]]),
    }
    new["encoder"] = enc
    return new
