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

- ``gather_rows`` (K1): (column chunk, row) blocks of a fixed 1,024
  vectors; the train steps and the store gather through it.
- ``gather_rows_chunked`` (P1): the same copy in chunks of ``chunk_cols``
  columns, one block a chunk (the JAX probe's ``s_block`` x 128).
- ``gather_rows_bulk`` (P2, and P3 at 4 stages): Hopper bulk copies through
  ``stages`` shared-memory stages in flight in each of one block per SM.

Each takes the plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises. There is no fallback.
"""

from __future__ import annotations

import torch

# shared-memory stages of gather_rows_bulk: the barriers the kernel holds
MAX_STAGES = 32


def gather_rows_reference(store: torch.Tensor, idx: torch.Tensor,
                          width: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels: clamp, then ``index_select``."""
    rows = store.index_select(0, idx.long().clamp(0, store.shape[0] - 1))
    return rows if width is None else rows[:, :width]


def gather_rows(store: torch.Tensor, idx: torch.Tensor,
                width: int | None = None) -> torch.Tensor:
    """Rows ``idx`` (B,) int32 or int64 of ``store`` (N, W), cut to the
    first ``width`` columns: (B, width), contiguous.

    ``gather_rows.launches`` counts the kernel's launches."""
    if _plain("gather_rows", store, idx):
        return gather_rows_reference(store, idx, width)
    return _launch("mtt_gather_rows", gather_rows, store, idx, width)


gather_rows.launches = 0


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


def _launch(symbol: str, wrapper, store: torch.Tensor, idx: torch.Tensor,
            width: int | None, *extra) -> torch.Tensor:
    """Check the arguments, allocate the (B, width) output and launch the
    C entry point ``symbol`` (store, ids, out, N, the two pitches and the
    row's bytes, then ``extra``, then B, the id width, the device and the
    stream) on the current stream; count the launch on ``wrapper``."""
    from masters_thesis_tpu_torch.ops import _build

    if store.ndim != 2 or store.stride(1) != 1 or store.shape[0] == 0:
        raise ValueError(f"store: expected a non-empty (N, W) tensor with "
                         f"unit column stride, got {tuple(store.shape)} with "
                         f"strides {store.stride()}")
    if idx.ndim != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx: expected a 1-D int32 or int64 tensor, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    n, w = store.shape
    width = w if width is None else int(width)
    if not 0 <= width <= w:
        raise ValueError(f"width {width} outside [0, {w}]")
    idx = idx.contiguous()
    out = torch.empty(idx.shape[0], width, dtype=store.dtype,
                      device=store.device)
    if out.numel() == 0:
        return out
    size = store.element_size()
    device = store.device
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    code = getattr(_build.load_library(), symbol)(
        store.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
        store.stride(0) * size, width * size, width * size, *extra,
        idx.shape[0], idx.element_size(), index,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check_error(code, wrapper.__name__)
    wrapper.launches += 1
    return out
