"""Launch calls a request's depthwise and squeeze-and-excitation part
takes: the runtime and driver calls that put a kernel on a stream
(``cudaLaunchKernel`` and its kin) starting inside an
``encode.depthwise_se`` range that lies inside an ``encode.backbone``
range of the traced window, over the number of those backbone ranges."""

from port_bench.harness.nested_spans import launches_a_request


def read(trace, bench):
    return launches_a_request(trace, "encode.depthwise_se", "encode.backbone")
