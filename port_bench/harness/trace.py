"""Spans the harness records around its calls into the program, and the
traced window: a ``torch.profiler`` trace of a fixed number of the cell's
units, reduced to kernel intervals, launch calls and host spans.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

# CUDA runtime and driver calls that put a kernel on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
SPAN_PREFIX = "span:"
WINDOW = "span:traced_window"


class Spans:
    """Host-clock durations of named spans; inside a traced window each
    span is also a ``record_function`` range of the trace."""

    def __init__(self):
        self.seconds = defaultdict(list)
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        ranged = (torch.profiler.record_function(SPAN_PREFIX + name)
                  if self.traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ranged:
            yield
        self.seconds[name].append(time.perf_counter() - t0)


class Trace:
    """What the metric readers read from a traced window: device intervals
    (kernels, copies, sets), the host's launch calls, its spans and other
    host operations, all in microseconds on the profiler's clock, and the
    counters the driver set."""

    def __init__(self, events, counters: dict):
        from torch.autograd import DeviceType

        self.counters = dict(counters)
        self.device, self.launches, self.host = [], [], []
        self.window = None
        for e in events:
            item = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                # a host range is also drawn on the device's timeline
                if not e.name.startswith(SPAN_PREFIX):
                    self.device.append(item)
            elif e.name == WINDOW:
                self.window = item[1:]
            elif e.name in LAUNCH_CALLS:
                self.launches.append(item)
            else:
                self.host.append(item)
        self.device.sort(key=lambda i: i[1])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernel_us(self, patterns) -> tuple[float, int]:
        """(summed microseconds, count) of the device operations whose name
        holds one of ``patterns``."""
        hits = [e - s for name, s, e in self.device
                if any(p in name for p in patterns)]
        return float(sum(hits)), len(hits)

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device's operations inside the window."""
        lo, hi = self.window
        out: list[list[float]] = []
        for _, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(i) for i in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def launch_count(self) -> int:
        lo, hi = self.window
        return sum(1 for _, s, _ in self.launches if lo <= s <= hi)

    def top_device_ops(self, n: int = 10) -> list:
        total = defaultdict(float)
        for name, s, e in self.device:
            total[name] += (e - s) / 1e6
        return [[k, v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps between device operations in the window,
        each named by what the host was doing at its middle: the innermost
        harness span and the innermost host operation covering it."""
        lo, hi = self.window
        edges = [lo] + [x for i in self.busy_intervals() for x in i] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        out = []
        for length, start in gaps:
            mid = start + length / 2
            covering = [(e - s, name) for name, s, e in
                        self.host + self.launches if s <= mid <= e]
            spans = [c for c in covering if c[1].startswith(SPAN_PREFIX)]
            ops = [c for c in covering if not c[1].startswith(SPAN_PREFIX)]
            name = " > ".join(min(part)[1] for part in (spans, ops) if part)
            out.append([name or "no host operation", length / 1e6])
        return out


def traced(run_units, spans: Spans, counters: dict) -> Trace:
    """Trace ``run_units()`` (which ends in a synchronise) under the
    profiler, its spans as ranges of the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    spans.traced = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                run_units()
                torch.cuda.synchronize()
    finally:
        spans.traced = False
    return Trace(prof.events(), counters)
