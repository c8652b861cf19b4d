"""The readers of the program's spans (``harness/program_spans.py`` and the
six ``metrics/*.decode.py`` on it) on a canned trace and canned device
spans, against values worked out by hand: a span that straddles the
window's edge, idle time under the profiler's buffer request, and
``None`` where the program left no span."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from masters_thesis_tpu_torch.utils import profiling
from port_bench.harness.bench import ROOT, load_module, read_json
from port_bench.harness.trace import WINDOW, Trace

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
READERS = ("inputs_host_ms.decode", "kernel_host_ms.decode",
           "inputs_launches.decode", "inputs_device_ms.decode",
           "kernel_device_ms.decode", "idle_in_program_share.decode")


def event(name, start, end, device=CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


class Stamp:
    """A CUDA event that completed at ``ms``."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def pair(name, start, end):
    return (name, Stamp(start), Stamp(end))


@pytest.fixture
def trace():
    """A window of 1,000 µs: the device busy 100-200, 300-500, 600-650;
    three requests' program spans, two under the harness's enqueue, a
    gather that began before the window and inputs that end after it; the
    profiler's buffer request over 0-80."""
    events = [
        event(WINDOW, 0, 1000),
        event("gemm", 100, 200, CUDA), event("tile_kernel", 300, 500, CUDA),
        event("copy", 600, 650, CUDA),
        # a program span's shadow on the device's timeline is no device work
        event("span:decode.kernel", 150, 290, CUDA),
        event("span:enqueue", 0, 700),
        event("Activity Buffer Request", 0, 80),
        event("span:gather", -20, 60),              # straddles the start
        event("span:decode.inputs", 60, 150),
        event("span:decode.kernel", 150, 290),
        event("span:gather", 500, 520),
        event("span:decode.inputs", 520, 560),
        event("span:decode.kernel", 560, 580),
        event("span:decode.inputs", 800, 830),
        event("span:decode.kernel", 830, 960),
        event("span:decode.inputs", 980, 1020),     # straddles the end
        event("aten::addmm", 90, 130),
        event("cudaLaunchKernel", 70, 72), event("cudaLaunchKernel", 100, 102),
        event("cuLaunchKernel", 140, 142), event("cudaLaunchKernel", 300, 302),
        event("cudaLaunchKernel", 530, 532),
        event("cudaLaunchKernel", 810, 812),
        event("cudaLaunchKernel", 990, 992),        # in the straddling span
        event("cudaLaunchKernel", 1100, 1105),      # after the window
    ]
    return Trace(events, {"decodes": 2, "batch": 64})


@pytest.fixture
def spans(monkeypatch):
    got = [pair("gather", 0.0, 0.01), pair("decode.inputs", 0.01, 0.81),
           pair("decode.kernel", 0.81, 3.81), pair("decode.inputs", 4.0, 4.6),
           pair("decode.kernel", 4.6, 7.4), pair("decode.inputs", 8.0, 8.7),
           # the host stalled inside the span: the device idled in it
           pair("decode.kernel", 8.7, 17.7)]
    monkeypatch.setattr(profiling, "device_spans", lambda: list(got))
    return got


def read(name, trace, config="lcnic_flagship"):
    bench = SimpleNamespace(config=read_json("configs", config))
    return load_module(ROOT / "port_bench" / "metrics" / f"{name}.py").read(
        trace, bench)


@pytest.mark.parametrize("name,want", [
    # the medians of the ranges wholly inside the window: 90, 40 and 30
    # µs; 140, 20 and 130 µs
    ("inputs_host_ms.decode", 0.040),
    ("kernel_host_ms.decode", 0.130),
    # launches at 70, 100, 140, at 530 and at 810, over three ranges; the
    # one at 990 lies in the range cut by the window's end
    ("inputs_launches.decode", 5 / 3),
    # the least extents: of 0.80, 0.60, 0.70 ms; of 3.00, 2.80, 9.00 ms
    ("inputs_device_ms.decode", 0.60),
    ("kernel_device_ms.decode", 2.80),
    # idle 0-100, 200-300, 500-600, 650-1000 within the program's spans,
    # clipped to the window (0-290, 500-580, 800-960, 980-1000): 100 + 90
    # + 80 + 160 + 20 µs, less 80 under the buffer request: 370 of 1,000
    ("idle_in_program_share.decode", 37.0),
])
def test_reader(trace, spans, name, want):
    assert read(name, trace) == pytest.approx(want, rel=1e-9)


def test_idle_in_program_lies_within_the_device_idle_share(trace, spans):
    assert read("idle_in_program_share.decode", trace) <= read(
        "device_idle_share.decode", trace) == pytest.approx(65.0)


def test_idle_gaps_name_the_innermost_program_span(trace):
    assert [(n, round(s * 1e6)) for n, s in trace.idle_gaps()] == [
        ("span:decode.inputs", 350),                # 650-1000, mid 825
        ("span:decode.inputs", 100),                # 500-600, under 520-560
        ("span:decode.kernel", 100),                # 200-300, under 150-290
        ("span:gather > Activity Buffer Request", 100)]


def test_readers_find_nothing_without_spans(monkeypatch):
    """A trace of a program without spans, an empty list of event pairs,
    and a program that has no ``device_spans`` at all."""
    empty = Trace([event(WINDOW, 0, 1000), event("gemm", 100, 200, CUDA),
                   event("span:enqueue", 0, 700),
                   event("cudaLaunchKernel", 70, 72)], {"decodes": 1})
    monkeypatch.setattr(profiling, "device_spans", lambda: [])
    for name in READERS:
        assert read(name, empty, "cnn_rnn") is None, name
    monkeypatch.delattr(profiling, "device_spans")
    for name in ("inputs_device_ms.decode", "kernel_device_ms.decode"):
        assert read(name, empty) is None, name
