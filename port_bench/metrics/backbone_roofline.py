"""The backbone's share of its roofline: the least time InceptionV3 can
take on a request's images (``reference/cnn_rnn_inception.py::
backbone_bound``: the images, the weights and the patches moved once, and
``backbone_flops`` an image at the fp32 peak, bound by its operations)
over the least device extent of the program's ``encode.backbone`` spans,
in %. The count follows the algorithm, not an implementation."""

from port_bench.harness.program_spans import least_device_ms
from port_bench.reference import family


def read(trace, bench):
    ms = least_device_ms("encode.backbone")
    bound = getattr(family(bench.config), "backbone_bound", None)
    if ms is None or bound is None:
        return None
    return 100.0 * bound(bench.config, trace.counters["batch"])[
        "bound_ms"] / ms
