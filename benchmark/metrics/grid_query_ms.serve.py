"""Device ms a served chunk in the grid queries: K10, its pre-pass and K11."""

from benchmark.metrics import class_ms


def read(rec):
    return class_ms(rec, "grid_query")
