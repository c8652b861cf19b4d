"""Packed dataset serialization — the TFRecord-pipeline equivalent.

The reference stores betas two ways: one ~1.25 MB .npy per trial
(ian_code/nsd_get_data.py:250-259; read back one-by-one per batch) and
TFRecords of 500 trials (misc/create_dataset.py, misc/config.py) consumed
with ``TFRecordDataset(num_parallel_reads=54)`` (ThinkAndTell/load_dataset.py).

The layout here: ONE contiguous little-endian binary per subject
(``data.bin`` memmap, shape (N, D)) + ``keys.npy`` + ``meta.json``. Writes
stream row-by-row (constant memory), reads are zero-copy ``np.memmap``.

The port's own copy of ``masters_thesis_tpu/data/pack.py``, with the same
names, meaning and on-disk format: a pack written by either package opens
in the other (``tests/test_torch_ingest.py``). ``open_pack`` returns the
port's host-resident ``ArrayStore`` over the memmap; ``ArrayStore.upload``
moves it to the card in row blocks.
"""

from __future__ import annotations

import json
import os

import numpy as np

from masters_thesis_tpu_torch.data.store import ArrayStore

MAGIC = "mtt-pack-v1"


class PackWriter:
    def __init__(self, directory: str, row_shape, dtype=np.float32):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.row_shape = tuple(int(x) for x in row_shape)
        self.dtype = np.dtype(dtype)
        self._f = open(os.path.join(directory, "data.bin"), "wb")
        self._keys: list[int] = []

    def add(self, key: int, row: np.ndarray) -> None:
        row = np.ascontiguousarray(row, dtype=self.dtype)
        assert row.shape == self.row_shape, (row.shape, self.row_shape)
        self._f.write(row.tobytes())
        self._keys.append(int(key))

    def close(self) -> dict:
        self._f.close()
        keys = np.asarray(self._keys, dtype=np.int64)
        np.save(os.path.join(self.directory, "keys.npy"), keys)
        meta = {
            "magic": MAGIC,
            "n_rows": len(self._keys),
            "row_shape": list(self.row_shape),
            "dtype": self.dtype.name,
        }
        with open(os.path.join(self.directory, "meta.json"), "w") as f:
            json.dump(meta, f)
        return meta


def write_pack(directory: str, keys, rows, dtype=np.float32) -> dict:
    """rows: iterable of (key, row) or an (N, D) array aligned with keys."""
    if isinstance(rows, np.ndarray):
        keys = list(keys)
        assert len(keys) == len(rows), (
            f"{len(keys)} keys vs {len(rows)} rows — zip would silently "
            "truncate to the shorter"
        )
        it = zip(keys, rows)
        row_shape = rows.shape[1:]
    else:
        rows = iter(rows)
        first = next(rows, None)
        if first is None:
            # open_pack supports zero-row packs, but the row shape can't be
            # inferred from nothing — a clear error beats a bare
            # StopIteration escaping from write_pack
            raise ValueError(
                "write_pack got an empty rows iterable; pass an (0, D) "
                "ndarray (with its keys) to write a valid empty pack")
        first_key, first_row = first
        row_shape = np.asarray(first_row).shape

        def chain():
            yield first_key, first_row
            yield from rows

        it = chain()
    w = PackWriter(directory, row_shape, dtype)
    for key, row in it:
        w.add(key, np.asarray(row))
    return w.close()


def open_pack(directory: str) -> ArrayStore:
    """The pack in ``directory`` as a host-resident store over its
    read-only memmap."""
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    assert meta["magic"] == MAGIC, f"not a pack dir: {directory}"
    keys = np.load(os.path.join(directory, "keys.npy"))
    shape = (meta["n_rows"], *meta["row_shape"])
    if meta["n_rows"] == 0:
        # np.memmap refuses empty files; an empty split is still a valid pack
        mm = np.empty(shape, dtype=np.dtype(meta["dtype"]))
    else:
        mm = np.memmap(
            os.path.join(directory, "data.bin"),
            dtype=np.dtype(meta["dtype"]), mode="r", shape=shape,
        )
    return ArrayStore(mm, keys, device_resident=False)
