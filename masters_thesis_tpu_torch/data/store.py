"""Beta / feature stores, in PyTorch.

Counterpart of ``masters_thesis_tpu/data/store.py::ArrayStore``. A
device-resident store keeps the whole (N, W) beta matrix on one device; the
shared ``BatchPipeline`` hands out int32 row ids, and each batch is gathered
on the device by K1 (``ops.gather.gather_rows``). The surface is the one the
pipeline and the trainer read: ``keys``, ``key_to_idx``, ``indices_for``,
``device_resident``, ``n_cols``, ``row_shape``, ``device_array()`` and
``device_gather(idx)``.

A host-resident store (``device_resident=False``) keeps the rows where they
are, a numpy array or the read-only ``np.memmap`` of a pack
(``data.pack.open_pack``), or ``RowConcat``, the rows of several such arrays
end to end; ``gather_host`` reads rows from an array or a memmap, and
``upload_rows`` moves any of them to a device in row blocks through one pinned staging buffer, never holding
the whole matrix in host memory (a real subject is 10,000 x 327,684 fp32,
13.1 GB).

The store is 2-D on the device: rows of more than one dimension, the (P, C)
conv-feature patches of the image families, are stored as P·C columns,
``row_shape`` keeps their shape, and K1 gathers them flat like any row (the
encoder, ``models.encoders.PatchDense``, shapes a gathered row back). The
TPU's lane-packed layout is not ported; under a model axis a rank's store
holds its columns of the grouped layout (``permute_rows`` with ``columns``,
``parallel.sharding.shard_store_array``). ``permute_rows`` lays rows out in
the encoder's grouped
padded order (``GroupLayout.permute_rows``) on whatever device they are, for
``LocallyDense(pregathered=True)``.
"""

from __future__ import annotations

import os
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


def permute_rows(data: torch.Tensor, layout, chunk: int = 256,
                 columns=None) -> torch.Tensor:
    """(N, n_voxels) -> (N, padded_total) in the grouped padded layout, with
    the same indices as ``GroupLayout.permute_rows``: padding slots read a
    zero column. Runs on ``data``'s device, ``chunk`` rows at a time, so the
    zero-padded copy never holds more than one chunk. ``columns`` (the
    voxel of each output column, n_voxels for a padding slot) takes another
    layout: a rank's columns under a model axis
    (``parallel.sharding.shard_store_array``)."""
    if data.ndim != 2 or data.shape[1] != layout.n_voxels:
        raise ValueError(f"expected (N, {layout.n_voxels}) rows, got "
                         f"{tuple(data.shape)}")
    flat = torch.as_tensor(layout.flat_indices() if columns is None
                           else columns, dtype=torch.long,
                           device=data.device)
    out = torch.empty(data.shape[0], len(flat), dtype=data.dtype,
                      device=data.device)
    for i in range(0, data.shape[0], chunk):
        out[i:i + chunk] = F.pad(data[i:i + chunk], (0, 1)).index_select(1,
                                                                        flat)
    return out


# one slot of the pinned staging buffer: rows are copied to the device in
# blocks of about this many bytes, two blocks in flight
UPLOAD_BLOCK_BYTES = 64 << 20


class RowConcat:
    """The rows of several host arrays end to end, uncopied, as
    ``upload_rows`` reads them: ``parts`` (the arrays), ``shape``, ``dtype``
    and ``len``. Two subjects' stores make one store this way."""

    def __init__(self, parts):
        self.parts = list(parts)
        shapes = {tuple(p.shape[1:]) for p in self.parts}
        dtypes = {np.dtype(p.dtype) for p in self.parts}
        if len(shapes) != 1 or len(dtypes) != 1:
            raise ValueError(f"parts of row shapes {sorted(shapes)} and "
                             f"dtypes {sorted(map(str, dtypes))}: expected "
                             f"one of each")
        self.shape = (sum(len(p) for p in self.parts), *shapes.pop())
        self.dtype = dtypes.pop()

    def __len__(self) -> int:
        return self.shape[0]


def upload_rows(data, device, dtype=None,
                block_bytes: int = UPLOAD_BLOCK_BYTES) -> torch.Tensor:
    """Host rows (N, ...) -> one (N, W) tensor on ``device`` in ``dtype``
    (by default the rows' own), equal bit for bit to a whole copy
    (``torch.from_numpy(np.asarray(data)).reshape(N, -1).to(device,
    dtype)``).

    ``data`` is a numpy array, a read-only memmap or a ``RowConcat``; it is
    read in blocks of about ``block_bytes``. To a CUDA device each block is
    read into one half of a pinned staging buffer and copied from there
    asynchronously while the next block is read into the other half, so the
    host never holds more than the two blocks; to the CPU each block is
    copied into place."""
    device = torch.device(device)
    n = len(data)
    width = int(np.prod(data.shape[1:], dtype=np.int64))
    src = torch.from_numpy(np.empty(0, data.dtype)).dtype
    out = torch.empty((n, width), dtype=dtype or src, device=device)
    if out.numel() == 0:
        return out
    block = max(1, block_bytes // (width * np.dtype(data.dtype).itemsize))
    parts = getattr(data, "parts", [data])
    cuda = device.type == "cuda"
    if cuda:
        staging = torch.empty((2, block, width), dtype=src, pin_memory=True)
        host = staging.numpy()
        stream = torch.cuda.current_stream(device)
        done = [None, None]
    row = slot = 0
    for part in parts:
        flat = part.reshape(len(part), width)
        for i in range(0, len(flat), block):
            rows = flat[i:i + block]
            m = len(rows)
            if not cuda:
                out[row:row + m] = torch.from_numpy(np.require(rows,
                                                               requirements="W"))
            else:
                if done[slot] is not None:
                    done[slot].synchronize()     # its last copy has left
                np.copyto(host[slot, :m], rows)
                out[row:row + m].copy_(staging[slot, :m], non_blocking=True)
                done[slot] = torch.cuda.Event()
                done[slot].record(stream)
                slot ^= 1
            row += m
    if cuda:
        stream.synchronize()
    return out


class ArrayStore:
    """Dense (N, ...) row store with key -> row lookup.

    Device-resident (the default): the rows live on ``device`` (by default
    ``cuda``; pass ``device="cpu"`` for the CPU) as (N, W), (N, P, C) rows
    kept as (N, P·C); ``dtype`` ('float32' | 'bfloat16',
    ``tpu.store_dtype``) casts them at upload, and by default they keep
    their own. Host-resident (``device_resident=False``): ``data`` is kept
    as it was given, a numpy array, a memmap or a ``RowConcat``, and
    ``upload`` moves it to a device."""

    def __init__(self, data, keys: Sequence[int], device=None, dtype=None,
                 device_resident: bool = True):
        keys = [int(k) for k in keys]
        if len(keys) != len(data):
            raise ValueError(f"{len(keys)} keys for {len(data)} rows")
        if len(set(keys)) != len(keys):
            # the key->row map would keep only the last row of a repeated key
            raise ValueError("duplicate store keys: average repeats first")
        self.key_to_idx = {k: i for i, k in enumerate(keys)}
        self.keys = np.asarray(keys, dtype=np.int64)
        self.device_resident = device_resident
        if len(np.shape(data)) < 2:
            raise ValueError(f"expected (N, ...) rows, got "
                             f"{tuple(np.shape(data))}")
        self._row_shape = tuple(int(d) for d in np.shape(data)[1:])
        if not device_resident:
            self.data = data
            self.device = None
            self.n_cols = int(np.prod(self._row_shape, dtype=np.int64))
            return
        data = torch.as_tensor(data)
        data = data.reshape(len(data), -1)
        dtype = store_dtype(dtype) if dtype else data.dtype
        self.data = data.to(device=resolve_device(device), dtype=dtype)
        self.device = self.data.device
        self.n_cols = int(self.data.shape[1])

    def indices_for(self, keys) -> np.ndarray:
        return np.asarray([self.key_to_idx[int(k)] for k in keys],
                          dtype=np.int32)

    def gather_host(self, idx) -> np.ndarray:
        """Rows ``idx`` of a host-resident store of one array or memmap, as
        they are stored."""
        if self.device_resident:
            raise ValueError("gather_host reads a host-resident store")
        return np.asarray(self.data[np.asarray(idx)])

    def upload(self, device=None, dtype=None) -> torch.Tensor:
        """The rows as one (N, n_cols) tensor on ``device`` (by default
        ``cuda``) in ``dtype`` ('float32' | 'bfloat16'; by default their
        own): a host-resident store's through ``upload_rows``, a
        device-resident store's by ``Tensor.to``."""
        device = resolve_device(device)
        dtype = store_dtype(dtype) if dtype else None
        if self.device_resident:
            return self.data.to(device=device, dtype=dtype or self.data.dtype)
        return upload_rows(self.data, device, dtype)

    def device_array(self) -> torch.Tensor:
        if not self.device_resident:
            raise ValueError("a host-resident store has no device array: "
                             "upload it first")
        return self.data

    def device_gather(self, idx) -> torch.Tensor:
        """Rows ``idx`` (B,) through K1: (B, n_cols)."""
        idx = torch.as_tensor(idx, device=self.device)
        return gather_rows(self.device_array(), idx)

    @property
    def row_shape(self) -> tuple[int, ...]:
        """The shape of one row as it was given: (n_cols,) for flat rows."""
        return self._row_shape

    def __len__(self) -> int:
        return len(self.keys)

    # ---- constructors: host-resident, as the JAX package's defaults ----
    @classmethod
    def from_npy_dir(cls, directory: str | os.PathLike, keys: Sequence[int],
                     filename_fn, dtype=np.float32) -> "ArrayStore":
        """Load per-key ``.npy`` files (the reference's on-disk layout,
        e.g. ``subj02_KID{key}.npy``) into one dense host matrix."""
        first = np.load(os.path.join(directory, filename_fn(keys[0])))
        out = np.zeros((len(keys),) + first.shape, dtype=dtype)
        out[0] = first
        for i, key in enumerate(keys[1:], start=1):
            out[i] = np.load(os.path.join(directory, filename_fn(key)))
        return cls(out, keys, device_resident=False)

    @classmethod
    def from_memmap(cls, path: str | os.PathLike, keys: Sequence[int], shape,
                    dtype=np.float32) -> "ArrayStore":
        """np.memmap-backed host store (cf. CNN_RNN/train.py:197-201)."""
        mm = np.memmap(path, dtype=dtype, mode="r", shape=tuple(shape))
        return cls(mm, keys, device_resident=False)
