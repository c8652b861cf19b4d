"""Profiling hooks on ``torch.profiler``.

Counterpart of ``masters_thesis_tpu/utils/profiling.py`` (reference: a
TensorBoard callback with ``update_freq='batch'`` and a commented-out
``profile_batch``, AttemptFour/main.py:202-211). The JAX package writes
XPlane traces (``*.xplane.pb``); the port writes Chrome traces
(``*.pt.trace.json``) through ``torch.profiler.tensorboard_trace_handler``.
TensorBoard's profile plugin and Perfetto read both. ``StepProfiler`` is
framework-free and a copy of the original.

``span`` names a layer of the program's work in a trace (``span:gather``,
``span:decode.inputs``, ``span:decode.kernel``): while a profiler records,
a ``record_function`` range on the profiler's clock, nested in the
caller's ranges, and on a CUDA tensor a timed CUDA event pair around the
layer's work on the current stream (``device_spans``). While none
records it costs one flag check and records nothing.

Only one ``torch.profiler`` may be active in a process: a trace here must
not overlap another profiler's window.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

# the prefix of a span's range: a reader of the trace knows a program span
# by it, and leaves out the range's shadow on the device's timeline
SPAN_PREFIX = "span:"
# event pairs kept in memory; past this many the oldest go first
MAX_DEVICE_SPANS = 4096

# (name, start event, end event) of each span recorded on a CUDA tensor
_DEVICE_SPANS: collections.deque = collections.deque(maxlen=MAX_DEVICE_SPANS)
_OFF = contextlib.nullcontext()


def span(name: str, on: torch.Tensor | None = None):
    """A context manager around one layer of the program's work.

    With no profiler recording it is a shared no-op: no range, no event.
    While one records, it opens ``record_function("span:" + name)``; and
    where ``on`` is a CUDA tensor it also records a timed event on the
    current stream of ``on``'s device at entry and at exit, kept as
    ``(name, start, end)`` for ``device_spans``."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, on)


class _Span:
    """A span while a profiler records (``span``)."""

    __slots__ = ("name", "device", "range", "start")

    def __init__(self, name: str, on: torch.Tensor | None):
        self.name = name
        self.device = on.device if on is not None and on.is_cuda else None

    def __enter__(self):
        self.range = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self.range.__enter__()
        if self.device is not None:
            self.start = _event(self.device)
        return self

    def __exit__(self, *exc):
        if self.device is not None and exc[0] is None:
            _DEVICE_SPANS.append((self.name, self.start,
                                  _event(self.device)))
        return self.range.__exit__(*exc)


def _event(device: torch.device) -> torch.cuda.Event:
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def device_spans() -> list:
    """The ``(name, start event, end event)`` of the spans recorded on CUDA
    tensors since ``start_trace`` last cleared them (at most
    ``MAX_DEVICE_SPANS``, the newest), oldest first. A span's device extent
    is ``start.elapsed_time(end)`` in ms once ``end`` has completed: the
    device time of the layer's work on its stream, idle time inside it
    included."""
    return list(_DEVICE_SPANS)


def start_trace(logdir: str, device=None) -> torch.profiler.profile:
    """Start a profiler that records CPU activity, and CUDA activity when
    ``device`` is a CUDA device, and writes a Chrome trace under ``logdir``
    when it stops. Clears ``device_spans``."""
    _DEVICE_SPANS.clear()
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
