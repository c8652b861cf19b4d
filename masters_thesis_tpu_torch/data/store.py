"""Device-resident beta store, in PyTorch.

Counterpart of ``masters_thesis_tpu/data/store.py::ArrayStore`` for its
device-resident mode: the whole (N, W) beta matrix lives on one device, the
shared ``BatchPipeline`` hands out int32 row ids, and each batch is gathered
on the device by K1 (``ops.gather.gather_rows``). The surface is the one the
pipeline and the trainer read: ``keys``, ``key_to_idx``, ``indices_for``,
``device_resident``, ``n_cols``, ``row_shape``, ``device_array()`` and
``device_gather(idx)``.

The store is 2-D: rows of more than one dimension, the (P, C) conv-feature
patches of the image families, are stored as P·C columns, ``row_shape``
keeps their shape, and K1 gathers them flat like any row (the encoder,
``models.encoders.PatchDense``, shapes a gathered row back). The TPU's
lane-packed layout is not ported, and the mesh-sharded store waits for the
``parallel`` port. ``permute_rows`` lays rows
out in the encoder's grouped padded order (``GroupLayout.permute_rows``) on
whatever device they are, for ``LocallyDense(pregathered=True)``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from masters_thesis_tpu_torch.device import resolve_device
from masters_thesis_tpu_torch.ops.gather import gather_rows

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def store_dtype(name: str) -> torch.dtype:
    """``tpu.store_dtype`` ('float32' | 'bfloat16') as a torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"store dtype {name!r}: expected one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


def permute_rows(data: torch.Tensor, layout, chunk: int = 256) -> torch.Tensor:
    """(N, n_voxels) -> (N, padded_total) in the grouped padded layout, with
    the same indices as ``GroupLayout.permute_rows``: padding slots read a
    zero column. Runs on ``data``'s device, ``chunk`` rows at a time, so the
    zero-padded copy never holds more than one chunk."""
    if data.ndim != 2 or data.shape[1] != layout.n_voxels:
        raise ValueError(f"expected (N, {layout.n_voxels}) rows, got "
                         f"{tuple(data.shape)}")
    flat = torch.as_tensor(layout.flat_indices(), dtype=torch.long,
                           device=data.device)
    out = torch.empty(data.shape[0], len(flat), dtype=data.dtype,
                      device=data.device)
    for i in range(0, data.shape[0], chunk):
        out[i:i + chunk] = F.pad(data[i:i + chunk], (0, 1)).index_select(1,
                                                                        flat)
    return out


class ArrayStore:
    """Dense (N, W) row store on ``device`` (by default ``cuda``; pass
    ``device="cpu"`` for the CPU), with key -> row lookup; (N, P, C) rows
    are kept as (N, P·C). ``dtype``
    ('float32' | 'bfloat16', ``tpu.store_dtype``) casts the rows at upload;
    by default they keep their own."""

    device_resident = True

    def __init__(self, data, keys: Sequence[int], device=None, dtype=None):
        keys = [int(k) for k in keys]
        if len(keys) != len(data):
            raise ValueError(f"{len(keys)} keys for {len(data)} rows")
        if len(set(keys)) != len(keys):
            # the key->row map would keep only the last row of a repeated key
            raise ValueError("duplicate store keys: average repeats first")
        self.key_to_idx = {k: i for i, k in enumerate(keys)}
        self.keys = np.asarray(keys, dtype=np.int64)
        data = torch.as_tensor(data)
        if data.ndim < 2:
            raise ValueError(f"expected (N, ...) rows, got "
                             f"{tuple(data.shape)}")
        self._row_shape = tuple(int(d) for d in data.shape[1:])
        data = data.reshape(len(data), -1)
        dtype = store_dtype(dtype) if dtype else data.dtype
        self.data = data.to(device=resolve_device(device), dtype=dtype)
        self.device = self.data.device
        self.n_cols = int(self.data.shape[1])

    def indices_for(self, keys) -> np.ndarray:
        return np.asarray([self.key_to_idx[int(k)] for k in keys],
                          dtype=np.int32)

    def device_array(self) -> torch.Tensor:
        return self.data

    def device_gather(self, idx) -> torch.Tensor:
        """Rows ``idx`` (B,) through K1: (B, n_cols)."""
        idx = torch.as_tensor(idx, device=self.device)
        return gather_rows(self.data, idx)

    @property
    def row_shape(self) -> tuple[int, ...]:
        """The shape of one row as it was given: (n_cols,) for flat rows."""
        return self._row_shape

    def __len__(self) -> int:
        return len(self.keys)
