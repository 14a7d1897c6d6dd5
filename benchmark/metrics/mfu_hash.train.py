"""A hash-grid field's training steps' product operations
(``counts/hashgrid.ray_flops``: five MLP evaluations a foreground sample,
forward and backward, the colour head, the background, the sampler) over
the traced window's seconds and the float32 peak (``counts/peaks``), in %;
None for another field."""

from benchmark import trace as T
from benchmark.counts import hashgrid, peaks


def read(rec):
    if not rec["train"] or not hashgrid.is_hash(rec["cfg"]):
        return None
    flops = hashgrid.ray_flops(rec["cfg"]) * rec["batch"] * rec["steps"]
    return 100.0 * flops / T.window_seconds(rec["trace"]) / peaks.PEAK_FLOPS[rec["cfg"]["dtype"]]
