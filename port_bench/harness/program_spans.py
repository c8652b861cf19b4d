"""Reductions of the program's own spans (``masters_thesis_tpu_torch.utils.
profiling.span``) for the per-layer readers: the host ranges
``span:gather``, ``span:decode.inputs`` and ``span:decode.kernel`` in the
traced window, and the device extents of the program's CUDA event pairs.
A host time is the median over the window's spans: a window holds 16 to
24 requests, and one stall of the shared host (the profiler's buffer
request in the first request's gather, 3-4 ms; others up to 11 ms) moves
a mean by 5-20% there. A device time is the least extent over the
window's spans: an extent is the layer's device work and whatever idle
time falls inside it, which only lengthens it, and where the traced host
falls behind the device that idle reaches most spans of the window
(``idle_in_program_share`` reads it).

A program without these spans leaves the trace without them and has no
``device_spans``: every reduction then finds nothing, and its reader
returns ``None``.
"""

from __future__ import annotations

import statistics

from port_bench.harness.trace import SPAN_PREFIX

PROGRAM_SPANS = ("gather", "decode.inputs", "decode.kernel")
# the profiler's own work at the window's start, which stalls the host
BUFFER_REQUEST = "Activity Buffer Request"


def host_spans(trace, name: str) -> list[tuple[float, float]]:
    """(start, end) in µs of the host ranges of span ``name`` that lie
    wholly inside the traced window."""
    lo, hi = trace.window
    key = SPAN_PREFIX + name
    return [(s, e) for n, s, e in trace.host
            if n == key and lo <= s and e <= hi]


def median_host_ms(trace, name: str) -> float | None:
    spans = host_spans(trace, name)
    if not spans:
        return None
    return statistics.median(e - s for s, e in spans) / 1e3


def launches_a_span(trace, name: str) -> float | None:
    """Launch calls that start inside a range of span ``name``, over the
    number of such ranges."""
    spans = host_spans(trace, name)
    if not spans:
        return None
    n = sum(1 for _, t, _ in trace.launches
            if any(s <= t <= e for s, e in spans))
    return n / len(spans)


def device_extents_ms(name: str) -> list[float]:
    """The device extent in ms of each event pair the program recorded for
    span ``name``; none where the program records no pairs."""
    try:
        from masters_thesis_tpu_torch.utils.profiling import device_spans
    except ImportError:
        return []
    out = []
    for n, start, end in device_spans():
        if n == name:
            end.synchronize()
            out.append(start.elapsed_time(end))
    return out


def least_device_ms(name: str) -> float | None:
    extents = device_extents_ms(name)
    return min(extents) if extents else None


def union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(i) for i in out]


def intersect(a, b) -> list[tuple[float, float]]:
    """The intersection of two unions of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def complement(a, lo: float, hi: float) -> list[tuple[float, float]]:
    """[lo, hi] less a union of disjoint intervals inside it."""
    edges = [lo] + [x for i in a for x in i] + [hi]
    return [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]


def idle_in_program_share(trace) -> float | None:
    """The share of the window, in %, in which the device was idle while the
    host was inside a program span; idle time under the profiler's buffer
    request is left out."""
    lo, hi = trace.window
    clip = lambda items: union((max(s, lo), min(e, hi))  # noqa: E731
                               for s, e in items)
    program = clip((s, e) for n, s, e in trace.host
                   if n in {SPAN_PREFIX + p for p in PROGRAM_SPANS})
    if not program:
        return None
    idle = complement(trace.busy_intervals(), lo, hi)
    buffer = clip((s, e) for n, s, e in trace.host if n == BUFFER_REQUEST)
    stalled = intersect(idle, program)
    hidden = intersect(stalled, buffer)
    us = sum(e - s for s, e in stalled) - sum(e - s for s, e in hidden)
    return 100.0 * us / (hi - lo)
