"""Where the port's entry points run: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or ``cuda`` when it is None. A CUDA device without a
    usable card raises: nothing carries on on the CPU unless the caller
    passed ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested (the default) but CUDA is not "
            f"available; pass device='cpu' to run on the CPU")
    return device


def card_line(device) -> str:
    """What a time taken on ``device`` was taken on: the card's name and
    power limit as ``nvidia-smi`` gives them, or a note that the CPU's host
    clock times no device."""
    if torch.device(device).type != "cuda":
        return "cpu, host clock: no device time"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
