"""The whole decode's share of the card's peak in the precision the
configuration states: the model FLOPs a caption (the family's
``reference/<model>.py::caption_flops``: the encoder, the features'
projection and every step) times the captions/s of the run's window, over
the peak, in %."""

from port_bench.reference import family
from port_bench.reference.roofline import PEAKS


def read(trace, bench):
    c = bench.config
    flops = family(c).caption_flops(c)
    return 100.0 * flops * trace.counters["captions_per_s"] / PEAKS[
        c["precision"]]
