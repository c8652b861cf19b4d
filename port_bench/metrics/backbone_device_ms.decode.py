"""Device milliseconds of a request's backbone: the least extent of the
program's ``encode.backbone`` event pairs (``utils/profiling.py::
device_spans``) in the traced window, InceptionV3's work on the stream
inside ``decode.inputs``; idle time inside a span only lengthens it."""

from port_bench.harness.program_spans import least_device_ms


def read(trace, bench):
    return least_device_ms("encode.backbone")
