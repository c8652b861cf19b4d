"""Launch calls a request's backbone takes: the runtime and driver calls
that put a kernel on a stream (``cudaLaunchKernel`` and its kin) starting
inside an ``encode.backbone`` range of the traced window, over the number
of such ranges. The eager InceptionV3's launch count a request."""

from port_bench.harness.program_spans import launches_a_span


def read(trace, bench):
    return launches_a_span(trace, "encode.backbone")
