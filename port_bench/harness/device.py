"""The few calls that differ between the card and a CPU test run."""

from __future__ import annotations

import gc

import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def info(device) -> dict:
    """The result's ``device`` object."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def host_buffer(shape, dtype, device) -> torch.Tensor:
    """A host buffer the device copies into without a staging copy."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


class Done:
    """Marks a point in the stream; ``wait`` returns once the work before
    it is done (a CUDA event, or at once on the CPU)."""

    def __init__(self, device):
        self.event = (torch.cuda.Event() if device.type == "cuda" else None)

    def record(self) -> None:
        if self.event is not None:
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()
