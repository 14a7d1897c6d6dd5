"""Device ms a served chunk inside ``render.foreground``: the SDF and colour
field at the samples and the volume rendering; the busy time between the
span's marker kernels (``benchmark/spans.py``), None where the trace holds
no marker of it."""

from benchmark.spans import span_ms


def read(rec):
    return span_ms(rec, "render.foreground")
