"""Device ms a training step inside ``train.backward``: ``loss.backward()``,
the field's double backward; the busy time between the span's marker
kernels (``benchmark/spans.py``), None where the trace holds no marker of
it."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "train.backward")
