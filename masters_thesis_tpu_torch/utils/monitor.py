"""Device monitoring and allocation gating on ``torch.cuda``.

Counterpart of ``masters_thesis_tpu/utils/monitor.py`` (reference
nv_monitor.py:7-141, a busy-wait until a GPU has free memory, and
CNN_RNN/check_mem.py:6-46). The stats keep PJRT's key names:
``bytes_in_use`` is ``torch.cuda.memory_allocated``, ``peak_bytes_in_use``
``max_memory_allocated`` (this process's tensors), and ``bytes_limit`` the
card's total memory from ``torch.cuda.mem_get_info``. A CPU device has no
stats, as JAX's CPU device has none.
"""

from __future__ import annotations

import time

import torch


def device_memory_stats(device=None) -> dict:
    """bytes_in_use / peak_bytes_in_use / bytes_limit of one CUDA device
    (by default the current one); ``{}`` for a CPU device."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return {}
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_limit": total,
    }


def memory_fraction_used(device=None) -> float:
    s = device_memory_stats(device)
    limit = s.get("bytes_limit") or s.get("bytes_reservable_limit")
    used = s.get("bytes_in_use")
    if not limit or used is None:
        return 0.0
    return used / limit


def wait_for_device(
    max_fraction: float = 0.5, wait_s: float = 10.0, timeout_s: float = 3600.0,
    device=None,
) -> bool:
    """Busy-wait until device memory use drops below ``max_fraction``
    (nv_monitor.monitor semantics). Returns False on timeout."""
    start = time.time()
    while time.time() - start < timeout_s:
        if memory_fraction_used(device) <= max_fraction:
            return True
        time.sleep(wait_s)
    return False
