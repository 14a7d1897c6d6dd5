"""What the hash-grid field's roofline readers share: a kernel's device
seconds by its name, over the least time of its work a step."""

from benchmark import trace as T
from benchmark.counts import hashgrid, peaks


def kernel_seconds(tr, name: str) -> tuple:
    """(seconds, launches) in the window of the kernels whose names hold
    ``name``."""
    lo, hi = tr.window
    secs, n = 0.0, 0
    for o in tr.ops:
        if name in o.name and lo <= o.start <= hi:
            secs += (min(o.end, hi) - o.start) * 1e-6
            n += 1
    return secs, n


def roofline(rec, kernel: str, part: str):
    """100 x the least seconds of a step's ``part`` ('encode' or 'grad')
    over the kernel's measured seconds a step."""
    h = rec.get("hash")
    secs, n = kernel_seconds(rec["trace"], kernel)
    if not h or not n:
        return None
    cfg, rays = rec["cfg"], rec["batch"]
    if part == "encode":
        least = hashgrid.encode_bytes(cfg, hashgrid.encode_points(cfg, rays), h["touched_all"])
    else:
        least = hashgrid.grad_bytes(cfg, hashgrid.grad_points(cfg, rays), h["touched_grad"])
    return 100.0 * (least / peaks.PEAK_BYTES) / (secs / rec["steps"])
