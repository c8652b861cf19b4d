"""Launch calls a decode's inputs take: the runtime and driver calls that
put a kernel on a stream (``cudaLaunchKernel`` and its kin) starting inside
a ``decode.inputs`` range of the traced window, over the number of such
ranges. The eager encoder's launch count a request."""

from port_bench.harness.program_spans import launches_a_span


def read(trace, bench):
    return launches_a_span(trace, "decode.inputs")
