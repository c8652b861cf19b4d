"""Host milliseconds a request's enqueue takes: the harness's span around
the gather, the decode call and the copies' enqueue, averaged over every
request of the run's window."""


def read(trace, bench):
    return trace.counters["host_ms_per_batch"]
