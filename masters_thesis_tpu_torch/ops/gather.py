"""Batch row gather from a device-resident store, by hand in CUDA (K1), and
the two other splits of the same gather that ``scripts/gather_probe.py``
measures (P1, P2).

Counterpart of ``masters_thesis_tpu/ops/gather.py`` and of the Pallas
kernels of ``scripts/gather_probe.py``. The kernels are ``csrc/gather.cu``
(K1) and ``csrc/gather_probe.cu`` (P1, P2; their headers say what bounds
them on Hopper and how each design answers that); ``gather_rows_reference``
is the same computation in plain PyTorch, for all three:

    out[i] = store[clamp(idx[i], 0, N - 1), :width]

The store is a 2-D (N, W) tensor of any element type (fp32 or bf16 in use).
The TPU's lane-packed (N, S, 128) layout and ``pack_rows`` exist for the
TPU's DMA engine and are not ported. Out-of-range ids clamp, as on the TPU
path (the JAX package's ``jnp.take`` fallback fills NaN rows instead).

- ``gather_rows`` (K1): the train steps, the eval and the store gather
  through it while ``tpu.use_pallas`` is true (the default).
- ``take_rows``: the library take of ``tpu.use_pallas: false``, the port of
  the JAX package's unpacked ``jnp.take`` branch: clamp, then
  ``index_select``, on the card as on the CPU; it never launches K1.
  ``row_gather(cfg.tpu.use_pallas)`` picks one of the two for every
  gather of a run.
  ``gather_plan`` cuts each row by its bytes: a row under a block's sweep
  goes whole to a block sized to it, a vector a thread; a longer one into
  equal pieces of at most a sweep (half a sweep from 1 MiB), a block each.
- ``gather_rows_chunked`` (P1): the same copy in chunks of ``chunk_cols``
  columns, one block a chunk (the JAX probe's ``s_block`` x 128).
- ``gather_rows_bulk`` (P2, and P3 at 4 stages): Hopper bulk copies through
  ``stages`` shared-memory stages in flight in each of one block per SM.

Each takes the plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises. There is no fallback. A launch's host path
is kept short, since on the narrow stores it is longer than the kernel:
the checks read each property once, the C entry points are bound once,
the stream is PyTorch's raw current handle, and K1's sizes and plan go to
C as one launch record, made once a shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from masters_thesis_tpu_torch.ops import _build
from masters_thesis_tpu_torch.utils.profiling import span

# shared-memory stages of gather_rows_bulk: the barriers the kernel holds
MAX_STAGES = 32
# K1's largest block and the vectors each thread has in flight
# (csrc/gather.cu kThreads, kUnroll), and a warp
THREADS, UNROLL, WARP = 256, 4, 32
# the row bytes from which K1 reads through the read-only path in pieces of
# half a sweep (gather_plan)
WIDE_ROW = 1 << 20
_ID_TYPES = (torch.int32, torch.int64)


def gather_rows_reference(store: torch.Tensor, idx: torch.Tensor,
                          width: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels: clamp, then ``index_select``."""
    rows = store.index_select(0, idx.long().clamp(0, store.shape[0] - 1))
    return rows if width is None else rows[:, :width]


def gather_rows(store: torch.Tensor, idx: torch.Tensor,
                width: int | None = None) -> torch.Tensor:
    """Rows ``idx`` (B,) int32 or int64 of ``store`` (N, W), cut to the
    first ``width`` columns: (B, width), contiguous.

    ``gather_rows.launches`` counts the kernel's launches. The call is the
    span ``gather`` (``utils.profiling.span``)."""
    with span("gather", store):
        if store.is_cuda and idx.is_cuda:
            return _gather(store, idx, width)
        _plain("gather_rows", store, idx)   # raises unless both on the CPU
        return gather_rows_reference(store, idx, width)


gather_rows.launches = 0


def take_rows(store: torch.Tensor, idx: torch.Tensor,
              width: int | None = None) -> torch.Tensor:
    """Rows ``idx`` of ``store`` through the library, on whatever device
    both are: the gather of ``tpu.use_pallas: false``. Out-of-range ids
    clamp, as K1's do (the JAX ``jnp.take`` fills NaN rows for them; in
    range the two agree). The call is the span ``gather``."""
    with span("gather", store):
        return gather_rows_reference(store, idx, width)


def row_gather(kernel: bool):
    """The store gather of a run: K1 (``gather_rows``) where ``kernel``
    (``tpu.use_pallas``), else the library take (``take_rows``)."""
    return gather_rows if kernel else take_rows


class GatherPlan(NamedTuple):
    """How K1 copies a batch: loads of ``vec_bytes``; each row cut into
    ``pieces`` pieces of ``piece_vecs`` vectors (the last may be shorter),
    each piece copied by a block of ``threads`` threads (a multiple of
    ``WARP`` up to ``THREADS``, at most ``UNROLL`` vectors a thread); row
    loads marked evict-first where ``stream`` is 1."""
    vec_bytes: int
    threads: int
    pieces: int
    piece_vecs: int
    stream: int


def vector_bytes(align: int) -> int:
    """The widest load, 16, 8, 4, 2 or 1 bytes, that divides ``align``: the
    OR of both base addresses, the store's row pitch and the row's bytes."""
    return min(align & -align, 16)


@functools.lru_cache(maxsize=256)
def gather_plan(row_bytes: int, vec_bytes: int) -> GatherPlan:
    """K1's launch geometry for rows of ``row_bytes`` in loads of
    ``vec_bytes``; a block's sweep is ``THREADS`` x ``UNROLL`` vectors.

    - A row under a sweep (a 2 KB ThinkAndTell PCA row) is one piece for a
      block of a thread a vector, rounded up to a warp, up to ``THREADS``:
      such a batch is bound by latency, and a row a block spreads it over
      the most SMs.
    - A row up to ``WIDE_ROW`` bytes (img_nic's 401,408 B, cnn_rnn's 512
      KB) is cut into equal pieces of at most a sweep, a block each, so
      that no row ends in a half-empty block (25 pieces of 1,004 16-byte
      vectors, not 24.5 of 1,024).
    - A wider row (LcNIC's 1.6-1.9 MB) is cut into equal pieces of at most
      half a sweep.

    Rows under ``WIDE_ROW`` stream their loads (evict-first): the batch
    is read once, and its rows then leave L2 to the output, which the
    model reads next. Both choices are what measured faster on an H100
    at these widths (PERF.md)."""
    row_vecs = row_bytes // vec_bytes
    sweep = THREADS * UNROLL
    stream = int(row_bytes < WIDE_ROW)
    if row_vecs < sweep:
        threads = min(THREADS, -(-row_vecs // WARP) * WARP)
        return GatherPlan(vec_bytes, threads, 1, row_vecs, stream)
    if not stream:
        sweep //= 2
    pieces = -(-row_vecs // sweep)
    return GatherPlan(vec_bytes, THREADS, pieces, -(-row_vecs // pieces),
                      stream)


# (N, pitch, row bytes, B, id bytes, device, the bases' low 4 bits) -> the
# address and launch record of gather_plan's plan for it: a cache of a few
# shapes a process (cleared past 1,024), so that a launch builds no record
_RECORDS: dict = {}


def _pack(n: int, pitch: int, row: int, b: int, id_bytes: int, device: int,
          plan: GatherPlan):
    """The launch record ``mtt_gather_rows`` reads (its struct Launch): the
    sizes, the device and ``plan``, as eleven long longs."""
    return (ctypes.c_longlong * 11)(n, pitch, row, b, id_bytes, device,
                                    *plan)


def _record(key: tuple):
    """The cached launch record of ``key`` (see ``_RECORDS``)."""
    n, pitch, row, b, id_bytes, device, bases = key
    if len(_RECORDS) >= 1024:
        _RECORDS.clear()
    plan = gather_plan(row, vector_bytes(bases | pitch | row))
    record = _pack(n, pitch, row, b, id_bytes, device, plan)
    _RECORDS[key] = (ctypes.addressof(record), record)
    return _RECORDS[key]


def _gather(store: torch.Tensor, idx: torch.Tensor, width: int | None,
            plan: GatherPlan | None = None) -> torch.Tensor:
    """K1 on CUDA tensors: check, allocate, launch under ``plan`` (by
    default ``gather_plan``'s) on the current stream, count the launch.
    The launch record of the default plan is made once for each shape."""
    n, width, idx = _checked("gather_rows", store, idx, width)
    b = idx.shape[0]
    out = torch.empty(b, width, dtype=store.dtype, device=store.device)
    if not b or not width:
        return out
    size = store.element_size()
    src, dst = store.data_ptr(), out.data_ptr()
    device = store.get_device()
    key = (n, store.stride(0) * size, width * size, b, idx.element_size(),
           device, (src | dst) & 15)
    # the record stays referenced here until the C call has read it
    if plan is None:
        address, record = _RECORDS.get(key) or _record(key)
    else:
        record = _pack(*key[:6], plan)
        address = ctypes.addressof(record)
    code = _entry("mtt_gather_rows")(
        src, idx.data_ptr(), dst, address,
        torch._C._cuda_getCurrentRawStream(device))
    if code:
        _build.check_error(code, "gather_rows")
    gather_rows.launches += 1
    return out


def gather_rows_chunked(store: torch.Tensor, idx: torch.Tensor,
                        chunk_cols: int,
                        width: int | None = None) -> torch.Tensor:
    """``gather_rows``, each row copied by blocks of ``chunk_cols`` columns
    (the last one of a row may be shorter).

    ``gather_rows_chunked.launches`` counts the kernel's launches."""
    chunk_cols = int(chunk_cols)
    if chunk_cols < 1:
        raise ValueError(f"chunk_cols {chunk_cols}: expected at least 1")
    if _plain("gather_rows_chunked", store, idx):
        return gather_rows_reference(store, idx, width)
    return _launch("mtt_gather_rows_chunked", gather_rows_chunked, store,
                   idx, width, chunk_cols * store.element_size())


gather_rows_chunked.launches = 0


def gather_rows_bulk(store: torch.Tensor, idx: torch.Tensor, stages: int,
                     width: int | None = None) -> torch.Tensor:
    """``gather_rows`` by bulk copies with ``stages`` (1 to ``MAX_STAGES``)
    pieces in flight in each block. The store's first element must be
    16-byte aligned (a fresh tensor's is; a view at an odd offset is not).

    ``gather_rows_bulk.launches`` counts the kernel's launches."""
    stages = int(stages)
    if not 1 <= stages <= MAX_STAGES:
        raise ValueError(f"stages {stages} outside [1, {MAX_STAGES}]")
    if _plain("gather_rows_bulk", store, idx):
        return gather_rows_reference(store, idx, width)
    if store.data_ptr() % 16:
        raise ValueError(f"store: the bulk copies need a 16-byte aligned "
                         f"base, got address {store.data_ptr():#x}")
    return _launch("mtt_gather_rows_bulk", gather_rows_bulk, store, idx,
                   width, stages)


gather_rows_bulk.launches = 0


def _plain(name: str, store: torch.Tensor, idx: torch.Tensor) -> bool:
    """True for CPU tensors, False for tensors on one CUDA device; raises
    for anything else."""
    devices = {store.device, idx.device}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or store.device.type != "cuda":
        raise ValueError(
            f"{name} needs the store and the ids on one CUDA device or both "
            f"on the CPU; got {sorted(map(str, devices))}")
    return False


def _checked(name: str, store: torch.Tensor, idx: torch.Tensor,
             width: int | None) -> tuple:
    """(N, width, the ids contiguous) for a store and ids on CUDA devices;
    raises for two devices, a store that is not a non-empty (N, W) tensor
    of unit column stride, ids that are not 1-D int32 or int64, or a width
    outside [0, W]."""
    if store.get_device() != idx.get_device():
        _plain(name, store, idx)                # raises: two devices
    shape = store.shape
    if len(shape) != 2 or not shape[0] or store.stride(1) != 1:
        raise ValueError(f"store: expected a non-empty (N, W) tensor with "
                         f"unit column stride, got {tuple(shape)} with "
                         f"strides {store.stride()}")
    if idx.dim() != 1 or idx.dtype not in _ID_TYPES:
        raise ValueError(f"idx: expected a 1-D int32 or int64 tensor, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if width is None:
        width = shape[1]
    elif not 0 <= width <= shape[1]:
        raise ValueError(f"width {width} outside [0, {shape[1]}]")
    if not idx.is_contiguous():
        idx = idx.contiguous()
    return shape[0], int(width), idx


# C entry point name -> its bound ctypes function
_ENTRIES: dict = {}


def _entry(symbol: str):
    """The C entry point ``symbol`` of the kernel library, bound once."""
    fn = _ENTRIES.get(symbol)
    if fn is None:
        fn = _ENTRIES[symbol] = getattr(_build.load_library(), symbol)
    return fn


def _launch(symbol: str, wrapper, store: torch.Tensor, idx: torch.Tensor,
            width: int | None, *extra) -> torch.Tensor:
    """P1's and P2's launch: check the arguments, allocate the (B, width)
    output and launch the C entry point ``symbol`` (store, ids, out, N, the
    two pitches and the row's bytes, then ``extra``, then B, the id width,
    the device and the stream) on the current stream; count the launch on
    ``wrapper``."""
    n, width, idx = _checked(wrapper.__name__, store, idx, width)
    out = store.new_empty((idx.shape[0], width))
    if not out.numel():
        return out
    size = store.element_size()
    device = store.get_device()
    code = _entry(symbol)(
        store.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
        store.stride(0) * size, width * size, width * size, *extra,
        idx.shape[0], idx.element_size(), device,
        torch._C._cuda_getCurrentRawStream(device))
    if code:
        _build.check_error(code, wrapper.__name__)
    wrapper.launches += 1
    return out
