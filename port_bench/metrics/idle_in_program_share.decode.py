"""The share of the traced window, in %, in which the device was idle (the
complement of the union of its operations) while the host was inside one
of the program's spans ``gather``, ``decode.inputs`` or ``decode.kernel``.
Idle time under the profiler's own "Activity Buffer Request" is left
out."""

from port_bench.harness.program_spans import idle_in_program_share


def read(trace, bench):
    return idle_in_program_share(trace)
