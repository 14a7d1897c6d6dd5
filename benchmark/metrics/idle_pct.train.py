"""The share of the traced window with no operation on the device, in %."""

from benchmark.metrics import idle_pct


def read(rec):
    return idle_pct(rec)
