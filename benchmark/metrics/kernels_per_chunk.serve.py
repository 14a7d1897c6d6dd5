"""Device kernels in the traced window a served chunk."""

from benchmark.metrics import kernels_per_unit


def read(rec):
    return kernels_per_unit(rec)
