"""Batch row gather from a device-resident store, by hand in CUDA (K1).

Counterpart of ``masters_thesis_tpu/ops/gather.py``. The kernel is
``csrc/gather.cu`` (its header says what bounds it on Hopper and how the
design answers that); ``gather_rows_reference`` is the same computation in
plain PyTorch:

    out[i] = store[clamp(idx[i], 0, N - 1), :width]

The store is a 2-D (N, W) tensor of any element type (fp32 or bf16 in use).
The TPU's lane-packed (N, S, 128) layout and ``pack_rows`` exist for the
TPU's DMA engine and are not ported. Out-of-range ids clamp, as on the TPU
path (the JAX package's ``jnp.take`` fallback fills NaN rows instead).

``gather_rows`` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises. There is no fallback.
"""

from __future__ import annotations

import torch


def gather_rows_reference(store: torch.Tensor, idx: torch.Tensor,
                          width: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: clamp, then ``index_select``."""
    rows = store.index_select(0, idx.long().clamp(0, store.shape[0] - 1))
    return rows if width is None else rows[:, :width]


def gather_rows(store: torch.Tensor, idx: torch.Tensor,
                width: int | None = None) -> torch.Tensor:
    """Rows ``idx`` (B,) int32 or int64 of ``store`` (N, W), cut to the
    first ``width`` columns: (B, width), contiguous.

    ``gather_rows.launches`` counts the kernel's launches."""
    devices = {store.device, idx.device}
    if devices == {torch.device("cpu")}:
        return gather_rows_reference(store, idx, width)
    if len(devices) != 1 or store.device.type != "cuda":
        raise ValueError(
            f"gather_rows needs the store and the ids on one CUDA device or "
            f"both on the CPU; got {sorted(map(str, devices))}")
    return _launch(store, idx, width)


gather_rows.launches = 0


def _launch(store: torch.Tensor, idx: torch.Tensor,
            width: int | None) -> torch.Tensor:
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
    code = _build.load_library().mtt_gather_rows(
        store.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
        store.stride(0) * size, width * size, width * size, idx.shape[0],
        idx.element_size(), index,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check_error(code, "gather_rows")
    gather_rows.launches += 1
    return out
