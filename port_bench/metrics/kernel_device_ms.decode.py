"""Device milliseconds of a decode's kernel: the least extent of the
program's ``decode.kernel`` event pairs (``utils/profiling.py::
device_spans``) in the traced window. K2's or K3's time read by span,
whatever the kernels' names, with the gaps between its launches; idle
time inside a span only lengthens it."""

from port_bench.harness.program_spans import least_device_ms


def read(trace, bench):
    return least_device_ms("decode.kernel")
