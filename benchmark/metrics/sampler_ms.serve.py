"""Device ms a step (a chunk) in the sampler's kernels, K1 and K2, by name."""

from benchmark.metrics import class_ms


def read(rec):
    return class_ms(rec, "sampler")
