"""The depthwise and squeeze-and-excitation part's share of its roofline:
the least time the 26 blocks' depthwise convolutions, their BatchNorms and
swish, and their squeeze-and-excitation can take on a request's images
(``reference/cnn_rnn_efficientnet.py::depthwise_se_bound``: each block's
depthwise input read and gated output written once, its weights read
once, bound by the bytes) over ``depthwise_se_device_ms.decode``, in %.
The count follows the algorithm, not an implementation. A family without
the bound reads nothing."""

from port_bench.harness.nested_spans import least_nested_device_ms
from port_bench.reference import family


def read(trace, bench):
    bound = getattr(family(bench.config), "depthwise_se_bound", None)
    if bound is None:
        return None
    ms = least_nested_device_ms("encode.depthwise_se", "encode.backbone")
    if ms is None:
        return None
    return 100.0 * bound(bench.config, trace.counters["batch"])[
        "bound_ms"] / ms
