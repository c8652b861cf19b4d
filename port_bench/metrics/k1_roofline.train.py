"""K1's share of its roofline in the train step: the least time a batch's
gather can take (each pregathered row read once and written once at 3.35
TB/s) over K1's mean device time a launch, in %. K1's kernels by name."""

from port_bench.reference.atlas import padded_total
from port_bench.reference.roofline import gather_bound

PATTERNS = ("::gather_rows_kernel<",)


def read(trace, bench):
    us, n = trace.kernel_us(PATTERNS)
    if not n:
        return None
    row_bytes = 4 * padded_total(bench.config)
    least_us = 1e3 * gather_bound(trace.counters["batch"],
                                  row_bytes)["bound_ms"]
    return 100.0 * least_us / (us / n)
