"""Device ms a served chunk inside ``render.importance``: the importance
sampler (K1 / K2 rounds and the merges); the busy time between the span's
marker kernels (``benchmark/spans.py``), None where the trace holds no
marker of it."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "render.importance")
