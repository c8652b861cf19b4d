"""Device milliseconds of a request's depthwise and squeeze-and-excitation
part: the sum of the extents of the program's ``encode.depthwise_se``
event pairs (``utils/profiling.py::device_spans``; one a MBConv block,
26 in EfficientNet-B3) that fall inside one ``encode.backbone`` extent,
the least over the traced window's requests."""

from port_bench.harness.nested_spans import least_nested_device_ms


def read(trace, bench):
    return least_nested_device_ms("encode.depthwise_se", "encode.backbone")
