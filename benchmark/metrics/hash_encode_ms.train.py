"""Device ms a training step inside ``field.hash_encode``: the hash
encoding's kernel (K13), at every call (the importance sampler's, the
foreground's point and taps); the busy time between the span's marker
kernels (``benchmark/spans.py``), None where the trace holds no marker of
it."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "field.hash_encode")
