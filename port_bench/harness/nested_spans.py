"""Reductions of program spans nested in another span, a request's many
inner spans summed inside its one outer span (``encode.depthwise_se``,
one a block, inside ``encode.backbone``): the device extents of the
program's CUDA event pairs (``utils/profiling.py::device_spans``) and the
launch calls inside the host ranges. As in ``program_spans.py``, a device
time is the least over the window's requests, and a program without the
spans gives nothing, so its reader returns ``None``."""

from __future__ import annotations

from port_bench.harness.program_spans import host_spans


def _pairs() -> list:
    try:
        from masters_thesis_tpu_torch.utils.profiling import device_spans
    except ImportError:
        return []
    return list(device_spans())


def nested_device_ms(inner: str, outer: str) -> list[float]:
    """For each event pair of span ``outer`` that holds one of ``inner``,
    the sum of the extents in ms of the ``inner`` pairs inside it: an
    inner pair lies inside when it starts no earlier and ends no later on
    the stream's clock."""
    pairs = _pairs()
    outers = [(s, e) for n, s, e in pairs if n == outer]
    inners = [(s, e) for n, s, e in pairs if n == inner]
    for _, e in outers + inners:
        e.synchronize()
    out = []
    for os_, oe in outers:
        inside = [s.elapsed_time(e) for s, e in inners
                  if os_.elapsed_time(s) >= 0 and e.elapsed_time(oe) >= 0]
        if inside:
            out.append(sum(inside))
    return out


def least_nested_device_ms(inner: str, outer: str) -> float | None:
    sums = nested_device_ms(inner, outer)
    return min(sums) if sums else None


def launches_a_request(trace, inner: str, outer: str) -> float | None:
    """Launch calls that start inside a host range of span ``inner`` lying
    inside a range of span ``outer`` in the window, over the number of
    ``outer`` ranges that hold one."""
    outers = host_spans(trace, outer)
    inners = [(s, e) for s, e in host_spans(trace, inner)
              if any(os_ <= s and e <= oe for os_, oe in outers)]
    holding = [o for o in outers
               if any(o[0] <= s and e <= o[1] for s, e in inners)]
    if not holding:
        return None
    n = sum(1 for _, t, _ in trace.launches
            if any(s <= t <= e for s, e in inners))
    return n / len(holding)
