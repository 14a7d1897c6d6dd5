"""Device ms a training step inside ``field.hash_grad``: the table's
gradient (K14, the scatter-add and its buffer), inside ``train.backward``;
the busy time between the span's marker kernels (``benchmark/spans.py``),
None where the trace holds no marker of it."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "field.hash_grad")
