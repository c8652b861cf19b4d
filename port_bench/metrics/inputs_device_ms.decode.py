"""Device milliseconds of a decode's inputs: the least extent of the
program's ``decode.inputs`` event pairs (``utils/profiling.py::
device_spans``) in the traced window, the encoder's work on the stream;
idle time inside a span only lengthens it."""

from port_bench.harness.program_spans import least_device_ms


def read(trace, bench):
    return least_device_ms("decode.inputs")
