"""The least time of K1 and K2's work (``counts/sampler``, from the
configuration's widths and the rays of a step or chunk) over their measured
device time, in %."""

from benchmark.metrics import sampler_roofline


def read(rec):
    return sampler_roofline(rec)
