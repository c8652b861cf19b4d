"""CUDA launch calls a train step, counted from the host's runtime and
driver calls in the traced window (``cudaLaunchKernel`` and its kin), over
the steps traced."""


def read(trace, bench):
    n = trace.launch_count()
    return n / trace.counters["steps"] if n else None
