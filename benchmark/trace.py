"""Reading a ``torch.profiler`` window: the device's operations (kernels,
copies, sets) and the benchmark's own host ranges, and what the per-layer
metrics take from them: the busy time (the union of the device's
intervals), kernel time by name, the idle gaps labelled by the host range
that was open.

Origin: ``chip_smoke.profile_replays`` / ``profile_scan_frame`` (device
events of a replayed window from ``torch.profiler``), with the busy time
taken as a union of intervals rather than a sum, so that overlapping
operations are not counted twice."""

from __future__ import annotations

import functools
import json
import os
from typing import NamedTuple

HOST_PREFIX = "bench."  # the benchmark's own record_function ranges
WINDOW = "bench.window"  # the traced window's range


class Op(NamedTuple):
    name: str
    start: float  # microseconds, the profiler's clock
    end: float


class Trace(NamedTuple):
    ops: list  # device operations, sorted by start
    host: list  # the benchmark's host ranges (Op), sorted by start
    window: tuple  # (start, end) of the traced window, microseconds


def from_profiler(prof) -> Trace:
    """The device operations and host ranges of a finished profile; the
    window is the ``bench.window`` range, which must enclose a
    synchronise."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, host, annotations = [], [], set()
    events = prof.events()
    for e in events:
        if e.device_type != cuda and getattr(e, "is_user_annotation", False):
            annotations.add(e.name)
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False) or e.name in annotations:
                continue
            ops.append(Op(e.name, float(tr.start), float(tr.end)))
        elif e.name.startswith(HOST_PREFIX):
            host.append(Op(e.name, float(tr.start), float(tr.end)))
    windows = [h for h in host if h.name == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {WINDOW} ranges, not one")
    return Trace(sorted(ops, key=lambda o: o.start), sorted(host, key=lambda o: o.start),
                 (windows[0].start, windows[0].end))


def busy_intervals(tr: Trace) -> list:
    """The union of the device operations' intervals inside the window."""
    lo, hi = tr.window
    merged = []
    for o in tr.ops:
        s, e = max(o.start, lo), min(o.end, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(tr: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(tr)) * 1e-6


def window_seconds(tr: Trace) -> float:
    return (tr.window[1] - tr.window[0]) * 1e-6


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """The longest stretches of the window with nothing on the device, each
    [the innermost benchmark range open at its middle ('host' if none),
    seconds], longest first."""
    lo, hi = tr.window
    edges = [lo] + [x for iv in busy_intervals(tr) for x in iv] + [hi]
    gaps = []
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            mid = 0.5 * (s + e)
            inner = [h for h in tr.host if h.name != WINDOW and h.start <= mid <= h.end]
            name = min(inner, key=lambda h: h.end - h.start).name if inner else "host"
            gaps.append([name, (e - s) * 1e-6])
    return sorted(gaps, key=lambda g: -g[1])[:top]


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its trailing argument list, cut to ``width``."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip()
                break
    return name[:width]


def seconds_by_name(tr: Trace) -> dict:
    lo, hi = tr.window
    out = {}
    for o in tr.ops:
        s, e = max(o.start, lo), min(o.end, hi)
        if e > s:
            out[o.name] = out.get(o.name, 0.0) + (e - s) * 1e-6
    return out


def top_ops(tr: Trace, top: int = 10) -> list:
    by = {}
    for name, s in seconds_by_name(tr).items():
        key = short_name(name)
        by[key] = by.get(key, 0.0) + s
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def count_kernels(tr: Trace) -> int:
    """Device operations that start inside the window and are kernels (not
    the copies and sets the profiler names Memcpy / Memset)."""
    lo, hi = tr.window
    return sum(1 for o in tr.ops if lo <= o.start <= hi and not o.name.startswith(("Memcpy",
                                                                                   "Memset")))


@functools.lru_cache(maxsize=None)
def kernel_classes() -> dict:
    """The benchmark's own table of kernel-name patterns by class
    (``metrics/kernel_classes.json``)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "metrics",
                           "kernel_classes.json")) as f:
        return json.load(f)


def class_seconds(tr: Trace, cls: str) -> tuple:
    """(seconds, kernels) of the device operations whose names match one of
    class ``cls``'s patterns (case-insensitive substrings)."""
    pats = [p.lower() for p in kernel_classes()[cls]]
    secs, n = 0.0, 0
    for name, s in seconds_by_name(tr).items():
        low = name.lower()
        if any(p in low for p in pats):
            secs += s
            n += 1
    return secs, n
