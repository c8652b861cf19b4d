"""Host milliseconds of the program's ``decode.inputs`` span a decode (the
encoder, ``pre``, the head's vocab padding, the initial carry, as
``ops/fused_decode.py::decode_inputs`` enqueues them): the median duration
of its ranges in the traced window."""

from port_bench.harness.program_spans import median_host_ms


def read(trace, bench):
    return median_host_ms(trace, "decode.inputs")
