"""Device kernels in the traced window a training step."""

from benchmark.metrics import kernels_per_unit


def read(rec):
    return kernels_per_unit(rec)
