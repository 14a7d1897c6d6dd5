"""Per-layer metrics, one reader a file (``<metric>.py``: ``read(rec)``, the
value or None where the trace holds nothing for it), and what they share.

``rec`` is a traced run's record: "trace" (``benchmark/trace.Trace``),
"cfg" (the configuration file's dict), "train", and the work in the
window: "steps" and "batch" (training) or "chunks", "chunk" and "rays"
(serving: real pixels, the padding left out)."""

from ..counts import field, peaks, sampler
from .. import trace as T


def units(rec) -> int:
    """Steps (training) or chunks (serving) in the traced window."""
    return rec["steps"] if rec["train"] else rec["chunks"]


def unit_rays(rec) -> int:
    """Rays a step or a chunk (a chunk's padding included: the card runs it)."""
    return rec["batch"] if rec["train"] else rec["chunk"]


def mfu(rec) -> float:
    rays = rec["batch"] * rec["steps"] if rec["train"] else rec["rays"]
    flops = field.ray_flops(rec["cfg"], train=rec["train"]) * rays
    return 100.0 * flops / T.window_seconds(rec["trace"]) / peaks.PEAK_FLOPS[rec["cfg"]["dtype"]]


def idle_pct(rec) -> float:
    return 100.0 * (1.0 - T.busy_seconds(rec["trace"]) / T.window_seconds(rec["trace"]))


def kernels_per_unit(rec) -> float:
    return T.count_kernels(rec["trace"]) / units(rec)


def class_ms(rec, cls: str, required: bool = False):
    """Device ms a step or chunk in kernels of class ``cls``; None where the
    class ran nothing, or an error where ``required``."""
    secs, n = T.class_seconds(rec["trace"], cls)
    if n == 0:
        if required:
            raise RuntimeError(f"no kernel of class {cls!r} in the traced window")
        return None
    return 1e3 * secs / units(rec)


def sampler_roofline(rec):
    ms = class_ms(rec, "sampler")
    return None if not ms else 100.0 * sampler.least_ms(rec["cfg"], unit_rays(rec)) / ms
