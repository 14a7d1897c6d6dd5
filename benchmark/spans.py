"""Device time inside the program's own spans, from a traced window.

The port's device spans (``neuralrecon_w_tpu_torch/tracing.py``) launch a
marker kernel, ``span_mark_kernel<ID, END>``, at each span's entry (END 0)
and exit (END 1), in the captured step and chunk too, so every replay
leaves its markers in the profiler's device trace. A span's id maps to its
name through the program's ``tracing.SPANS``. Each begin pairs with the
next end of its id; a span's time is the device's busy time strictly
between the two markers (the union of the other operations' intervals,
the markers left out), summed over its pairs in the window. A checkout
whose program has no markers reads None for every span."""

from __future__ import annotations

import bisect
import re

from . import trace as T

MARKER = re.compile(r"span_mark_kernel<\s*(\d+)[uU]?\s*,\s*(\d+)[uU]?\s*>")


def marker(name: str):
    """(span id, end) of a marker kernel's name, else None."""
    if "span_mark_kernel" not in name:
        return None
    m = MARKER.search(name)
    return None if m is None else (int(m.group(1)), int(m.group(2)))


def span_ids() -> dict:
    """{span name: id} of the program's table; {} where it has none."""
    try:
        from neuralrecon_w_tpu_torch.tracing import SPANS
    except ImportError:
        return {}
    return {s.name: s.id for s in SPANS}


def pairs(tr: T.Trace, sid: int) -> list:
    """(end of the begin marker, start of the end marker) of each run of
    span ``sid`` inside the window, in order."""
    lo, hi = tr.window
    out, opened = [], None
    for o in tr.ops:
        mk = marker(o.name)
        if mk is None or mk[0] != sid or not lo <= o.start <= hi:
            continue
        if mk[1] == 0:
            opened = o.end
        elif opened is not None:
            out.append((opened, o.start))
            opened = None
    return out


def busy_between(tr: T.Trace, spans: list) -> float:
    """Seconds of the device busy with operations other than markers inside
    the (start, end) intervals of ``spans``."""
    merged = T.busy_intervals(T.Trace([o for o in tr.ops if marker(o.name) is None], tr.host,
                                      tr.window))
    starts = [s for s, _ in merged]
    total = 0.0
    for a, b in spans:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(merged) and merged[i][0] < b:
            s, e = max(merged[i][0], a), min(merged[i][1], b)
            if e > s:
                total += e - s
            i += 1
    return total * 1e-6


def span_ms(rec, name: str):
    """Device ms a step (a chunk) inside span ``name``; None where the trace
    holds no run of it."""
    from .metrics import units

    sid = span_ids().get(name)
    if sid is None:
        return None
    runs = pairs(rec["trace"], sid)
    if not runs:
        return None
    return 1e3 * busy_between(rec["trace"], runs) / units(rec)
