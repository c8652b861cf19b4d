"""Host milliseconds of the program's ``decode.kernel`` span a decode (the
wrapper of K2 or K3 in ``ops/fused_decode.py``: its checks, plans and
launch): the median duration of its ranges in the traced window."""

from port_bench.harness.program_spans import median_host_ms


def read(trace, bench):
    return median_host_ms(trace, "decode.kernel")
