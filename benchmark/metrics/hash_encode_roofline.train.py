"""The least time of a step's hash encodings (``counts/hashgrid``: the
points in, the features out, each distinct table entry the step touched
read once, at the card's memory rate) over K13's device time a step, in %;
None where the trace holds no K13 or the run recorded no touched entries."""

from benchmark.metrics.hash_common import roofline


def read(rec):
    return roofline(rec, "hash_encode_kernel", "encode")
