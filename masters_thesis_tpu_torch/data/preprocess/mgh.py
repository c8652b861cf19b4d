"""Pure-numpy FreeSurfer MGH/MGZ volume reader (and writer, for fixtures).

The reference pipeline reads per-session surface betas
(``lh/rh.betas_session{NN}.mgh``) and the Glasser atlas
(``lh/rh.HCP_MMP1.mgz``) through nibabel
(AttemptFour/ian_code/nsd_get_data.py:226-241, DataLoaders/
load_avg_betas.py:34-50). nibabel isn't in this image, and the MGH format
is simple enough to not need it: a fixed 284-byte big-endian header
followed by the raw voxel data (FreeSurfer ``mghformat``; ``.mgz`` is the
same stream gzip-compressed).

Header layout (big-endian):
  int32   version (1)
  int32   width, height, depth, nframes
  int32   type  (0 uchar, 1 int32, 3 float32, 4 int16)
  int32   dof
  int16   goodRASFlag
  194 B   RAS info / padding (data always starts at byte 284)
Data: width*height*depth*nframes values, x fastest (Fortran order over
(width, height, depth, nframes)). A footer (TR etc.) may follow; ignored.

The port's own copy of ``masters_thesis_tpu/data/preprocess/mgh.py``, with the same
names and meaning (``tests/test_torch_ingest.py`` holds the two together).
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

_HEADER_SIZE = 284
_DTYPES = {0: np.dtype(">u1"), 1: np.dtype(">i4"),
           3: np.dtype(">f4"), 4: np.dtype(">i2")}
_TYPE_CODES = {np.dtype(np.uint8): 0, np.dtype(np.int32): 1,
               np.dtype(np.float32): 3, np.dtype(np.int16): 4}


def _open(path: str):
    if str(path).endswith(".mgz") or str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_mgh(path: str) -> np.ndarray:
    """Read an .mgh/.mgz volume -> float32 array of shape
    (width, height, depth, nframes) — the axis order nibabel's
    ``get_fdata()`` returns (surface files are (V, 1, 1, T))."""
    with _open(path) as f:
        hdr = f.read(_HEADER_SIZE)
        if len(hdr) < _HEADER_SIZE:
            raise ValueError(f"{path}: truncated MGH header")
        version, width, height, depth, nframes, dtype_code = struct.unpack(
            ">6i", hdr[:24])
        if version != 1:
            raise ValueError(f"{path}: unsupported MGH version {version}")
        if dtype_code not in _DTYPES:
            raise ValueError(f"{path}: unsupported MGH data type {dtype_code}")
        dt = _DTYPES[dtype_code]
        n = width * height * depth * nframes
        raw = f.read(n * dt.itemsize)
        if len(raw) < n * dt.itemsize:
            raise ValueError(f"{path}: truncated MGH data")
    arr = np.frombuffer(raw, dtype=dt)
    # stored x-fastest: C-order shape is (nframes, depth, height, width)
    arr = arr.reshape(nframes, depth, height, width)
    return np.ascontiguousarray(
        arr.transpose(3, 2, 1, 0)).astype(np.float32)


def write_mgh(path: str, data: np.ndarray) -> None:
    """Write an array as .mgh/.mgz (test fixtures / converters). 1D/2D
    arrays are treated as surface data (V,) / (V, T) -> (V, 1, 1, T)."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None, None, None]
    elif data.ndim == 2:
        data = data[:, None, None, :]
    assert data.ndim == 4, f"need <=4 dims, got {data.shape}"
    dt = data.dtype
    if dt not in _TYPE_CODES:
        data = data.astype(np.float32)
        dt = data.dtype
    code = _TYPE_CODES[dt]
    hdr = struct.pack(">6i", 1, *data.shape, code)
    hdr += struct.pack(">ih", 0, 0)            # dof, goodRASFlag=0
    hdr += b"\x00" * (_HEADER_SIZE - len(hdr))
    # x-fastest on disk = C-order over (frames, depth, height, width)
    payload = np.ascontiguousarray(
        data.transpose(3, 2, 1, 0)).astype(
            _DTYPES[code].newbyteorder(">"), copy=False).tobytes()
    with (gzip.open(path, "wb")
          if str(path).endswith((".mgz", ".gz")) else open(path, "wb")) as f:
        f.write(hdr + payload)
