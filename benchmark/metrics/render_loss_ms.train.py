"""Device ms a training step inside ``train.render_loss``: the render and the
loss terms (the importance sampler, the background and the foreground
field's forward); the busy time between the span's marker kernels
(``benchmark/spans.py``), None where the trace holds no marker of it."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "train.render_loss")
