"""Device ms a step (a chunk) in matrix-product kernels, classed by name
(``metrics/kernel_classes.json``: cuBLAS / CUTLASS families and the port's
K-kernels); the run fails where the class ran nothing."""

from benchmark.metrics import class_ms


def read(rec):
    return class_ms(rec, "gemm", required=True)
