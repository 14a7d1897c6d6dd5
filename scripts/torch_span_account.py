"""Where a benchmark cell's traced window goes, by the program's spans, on
the card:

    python scripts/torch_span_account.py --cells train.op serve.op --seed 7 [--out f.json]

For each cell it runs the benchmark's traced window (``benchmark/harness``,
the cell's own kind and traffic) and reads, a step or a chunk: each device
span's busy ms between its markers (``benchmark/spans.py``) and the kernels
inside it, the device's busy ms, the markers' own count and device time;
and, over the window, each host span's total ms and the idle gaps of the
device labelled by the innermost range open at their middle, the
program's host spans (``serve.frame_in``, ``serve.frame_out``,
``train.inputs``) among the benchmark's own. One JSON line a cell."""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def account(rec) -> dict:
    from benchmark import spans as S
    from benchmark import trace as T
    from benchmark.metrics import units
    from neuralrecon_w_tpu_torch.tracing import DEVICE, SPANS

    tr, n = rec["trace"], units(rec)
    lo, hi = tr.window
    inside = [o for o in tr.ops if lo <= o.start <= hi]
    markers = [o for o in inside if S.marker(o.name) is not None]
    out = {"units": n, "busy_ms": 1e3 * T.busy_seconds(tr) / n,
           "window_ms": 1e3 * T.window_seconds(tr) / n,
           "idle_pct": 100.0 * (1.0 - T.busy_seconds(tr) / T.window_seconds(tr)),
           "kernels": T.count_kernels(tr) / n, "markers": len(markers) / n,
           "markers_ms": 1e3 * sum((o.end - o.start) * 1e-6 for o in markers) / n, "spans": {}}
    for s in SPANS:
        if s.kind != DEVICE:
            continue
        runs = S.pairs(tr, s.id)
        if not runs:
            continue
        starts = [a for a, _ in runs]
        kernels = 0
        for o in inside:
            i = bisect.bisect_right(starts, o.start) - 1
            kernels += (i >= 0 and o.end <= runs[i][1] and S.marker(o.name) is None
                        and not o.name.startswith(("Memcpy", "Memset")))
        out["spans"][s.name] = {"ms": S.span_ms(rec, s.name), "runs": len(runs) / n,
                                "kernels": kernels / n}
    host = {}
    for h in tr.host:
        if h.name != T.WINDOW:
            t = host.setdefault(h.name, [0, 0.0])
            t[0] += 1
            t[1] += (h.end - h.start) * 1e-3
    out["host_ms"] = {k: {"count": c, "ms": ms} for k, (c, ms) in sorted(host.items())}
    gaps = T.idle_gaps(tr, top=10 ** 6)
    by = {}
    for name, sec in gaps:
        t = by.setdefault(name, [0, 0.0])
        t[0] += 1
        t[1] += sec * 1e3
    out["idle_gaps_ms"] = {k: {"count": c, "ms": ms} for k, (c, ms) in
                           sorted(by.items(), key=lambda kv: -kv[1][1])}
    out["longest_gaps_ms"] = [[name, 1e3 * sec] for name, sec in gaps[:8]]
    out["long_gaps"] = gap_split(tr)
    return out


def gap_split(tr, least_s: float = 1e-3, step_us: float = 5.0) -> list:
    """Each idle gap of at least ``least_s``, in order: its start (ms from the
    window's), its ms, and its ms by the innermost host range open (sampled
    every ``step_us``)."""
    from benchmark import trace as T

    lo, hi = tr.window
    edges = [lo] + [x for iv in T.busy_intervals(tr) for x in iv] + [hi]
    host = [h for h in tr.host if h.name != T.WINDOW]
    out = []
    for s, e in zip(edges[0::2], edges[1::2]):
        if (e - s) * 1e-6 < least_s:
            continue
        split, t = {}, s + 0.5 * step_us
        while t < e:
            inner = [h for h in host if h.start <= t <= h.end]
            name = min(inner, key=lambda h: h.end - h.start).name if inner else "host"
            split[name] = split.get(name, 0.0) + step_us * 1e-3
            t += step_us
        out.append({"at_ms": (s - lo) * 1e-3, "ms": (e - s) * 1e-3, "by": split})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace-frames", type=int, default=None,
                    help="frames in a serving cell's traced window (default: the traffic's)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import correct, harness
    from benchmark import trace as T

    if not torch.cuda.is_available():
        print("torch_span_account: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # keep the program's host spans beside the benchmark's own ranges
    T.HOST_PREFIX = ("bench.", "serve.", "train.")
    lines = []
    for cell in args.cells:
        wl = harness.workload(harness.spec(), cell)
        over = None if args.trace_frames is None else {"trace_frames": args.trace_frames}
        ctx = harness.Context(cell, wl, args.seed, 1.0, True, "cuda", time.perf_counter(),
                              traffic_over=over if harness.traffic(wl["traffic"])["kind"]
                              == "serve_frames" else None)
        got = harness.kind(ctx.traffic["kind"]).run(ctx)
        rec = dict(got["rec"], cfg=ctx.cfg)
        line = {"cell": cell, "seed": args.seed, "device": torch.cuda.get_device_name(0),
                "correct": correct.judge(got["numbers"], ctx.limits) and got["failed"] == 0,
                **account(rec)}
        lines.append(line)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
