"""The least time of a step's table gradient (``counts/hashgrid``: the
points and their gradients in, each distinct entry the backward reached
read and written once, at the card's memory rate) over K14's device time a
step, in %; None where the trace holds no K14 or the run recorded no
touched entries."""

from benchmark.metrics.hash_common import roofline


def read(rec):
    return roofline(rec, "hash_grad_kernel", "grad")
