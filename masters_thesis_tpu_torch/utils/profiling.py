"""Profiling hooks on ``torch.profiler``.

Counterpart of ``masters_thesis_tpu/utils/profiling.py`` (reference: a
TensorBoard callback with ``update_freq='batch'`` and a commented-out
``profile_batch``, AttemptFour/main.py:202-211). The JAX package writes
XPlane traces (``*.xplane.pb``); the port writes Chrome traces
(``*.pt.trace.json``) through ``torch.profiler.tensorboard_trace_handler``.
TensorBoard's profile plugin and Perfetto read both. ``StepProfiler`` is
framework-free and a copy of the original.

Only one ``torch.profiler`` may be active in a process: a trace here must
not overlap another profiler's window.
"""

from __future__ import annotations

import contextlib
import time

import torch


def start_trace(logdir: str, device=None) -> torch.profiler.profile:
    """Start a profiler that records CPU activity, and CUDA activity when
    ``device`` is a CUDA device, and writes a Chrome trace under ``logdir``
    when it stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    return prof


@contextlib.contextmanager
def profile_trace(logdir: str, device=None):
    """Capture a ``torch.profiler`` trace of the enclosed block under
    ``logdir`` (``*.pt.trace.json``)."""
    prof = start_trace(logdir, device)
    try:
        yield prof
    finally:
        prof.stop()


class StepProfiler:
    """Record wall-time of step windows (e.g. batches 200..220 like the
    reference's profile_batch) and dump simple stats."""

    def __init__(self, start_step: int = 0, end_step: int = 0):
        self.start_step = start_step
        self.end_step = end_step
        self.times: list[float] = []
        self._t = None

    def maybe_tick(self, step: int) -> None:
        now = time.perf_counter()
        active = self.start_step <= step <= self.end_step
        if self._t is not None and active:
            self.times.append(now - self._t)
        self._t = now if active else None

    def summary(self) -> dict:
        if not self.times:
            return {}
        times = sorted(self.times)
        n = len(times)
        return {
            "steps": n,
            "mean_s": sum(times) / n,
            "p50_s": times[n // 2],
            "p99_s": times[min(n - 1, int(n * 0.99))],
        }
