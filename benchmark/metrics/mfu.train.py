"""The step's (or served chunk's) required operations, as counted by
``counts/field.ray_flops``, over the traced window's seconds and the card's
peak for the configuration's dtype (``counts/peaks``), in %."""

from benchmark.metrics import mfu


def read(rec):
    return mfu(rec)
