"""Device ms a training step inside ``train.optimizer``: the gradient clip
and the optimiser's update; the busy time between the span's marker
kernels (``benchmark/spans.py``), None where the trace holds no marker of
it."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "train.optimizer")
