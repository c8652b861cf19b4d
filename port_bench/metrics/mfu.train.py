"""The whole train step's share of the card's peak in the precision the
configuration states: the model FLOPs a sample (the family's
``reference/<model>.py::train_flops_per_sample``, forward and backward)
times the samples/s of the run's window, over the peak, in %."""

from port_bench.reference import family
from port_bench.reference.roofline import PEAKS


def read(trace, bench):
    c = bench.config
    flops = family(c).train_flops_per_sample(c)
    return 100.0 * flops * trace.counters["samples_per_s"] / PEAKS[
        c["precision"]]
