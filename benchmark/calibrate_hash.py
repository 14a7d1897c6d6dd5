#!/usr/bin/env python3
"""The readings that the train.neuralangelo cell's correctness limits are
set from, over many seeds in one process:

    python3 benchmark/calibrate_hash.py --seeds <n> [<n> ...]

For each seed it drives the cell's first steps as a run does, then prints
one JSON line of ``train_window_hash.numbers`` (the table's leaf over the
rows the float32 reference reached) for the program against the float32
reference ("program"), and for the reference with a fault planted, put in
the program's place: "control" (computed one precision down, the cell
file's control), "levels_15" (the encoding one level short), "mirrored_tap"
(the first tap at x - e k_1), "half_batch" (half of each batch left out),
the table's gradient broken as a faulty scatter-add would break it in
every step, "table_grad_zero" (nothing scattered), "table_drop_0" and
"table_drop_15" (the coarsest or the finest level's rows left out),
"table_shift" (each level's rows one entry on); "table_unchanged" (the
program's steps with the table left as it was); and "weights": what the
steady-state weights make of the field at points of the unit ball (the
sdf's move by the grid, the taps' gradient norm).

With ``--f64`` it also runs the reference in float64 and prints, under
"f64", the numbers of the program and of the float32 reference each
against it, and each leaf's ratio of first-gradient norms (program over
float32 reference, each over float64) with the clip's factors: where the
global-norm clip scales every leaf by one factor, the ratios are that
factor on every leaf. The benchmark's runs do not run this."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def weight_readings(ctx, p) -> dict:
    import torch

    from benchmark.reference import hashgrid as H
    from benchmark.reference import precision

    sdf = ctx.cfg["NEUCONW"]["SDF_CONFIG"]
    g = ctx.generator("sample")
    x = torch.randn(65536, 3, generator=g, device=ctx.device)
    x = x / x.norm(dim=-1, keepdim=True) * torch.rand(65536, 1, generator=g,
                                                      device=ctx.device) ** (1 / 3)
    prec = precision.Precision()
    with torch.no_grad():
        s, _, grad, lap = H.taps(p["weights"], sdf, prec, x, int(sdf["levels"]), True)
        s0, _ = H.sdf_feature(p["weights"], sdf, prec, x, 0)
    gn = grad.norm(dim=-1)
    return {"grid_move_mean_abs": float((s - s0).abs().mean()),
            "grid_move_std": float((s - s0).std()), "grad_norm_median": float(gn.median()),
            "grad_norm_p90": float(gn.quantile(0.9)), "lap_abs_median": float(lap.abs().median())}


def norm_ratios(a: dict, b: dict, keys) -> dict:
    """Each leaf's |a| / |b|, summarised: the least, the median and the
    largest (each with its leaf) and the table's."""
    import torch

    from benchmark.traffic.train_window_hash import TABLE

    def n(t):
        return float(torch.linalg.vector_norm(t.double()))

    r = sorted((n(a[k]) / max(n(b[k]), 1e-300), k) for k in keys)
    return {"min": r[0], "median": r[len(r) // 2], "max": r[-1],
            "table": n(a[TABLE]) / max(n(b[TABLE]), 1e-300), "leaves": len(r)}


def f64_readings(ctx, p, first, ref) -> dict:
    """The program and the float32 reference against the float64 one."""
    import torch

    from benchmark import correct
    from benchmark.traffic import train_window_hash as K

    r64 = K.reference(ctx, p, first, dtype=torch.float64)
    rows, w = r64["rows"], p["weights"]
    kept = correct.kept_leaves(r64["grads"])
    sdf = ctx.cfg["NEUCONW"]["SDF_CONFIG"]
    out = {"program": K.numbers(first, r64, w, rows, sdf, True),
           "ref32": K.numbers(ref, r64, w, rows, sdf, True),
           "losses64": r64["losses"]}
    for name, side, base in (("program", first, r64), ("ref32", ref, r64),
                             ("program_ref32", first, ref)):
        out[f"{name}_norm_ratios"] = norm_ratios(K._rows_only(side["grads"], rows),
                                                 K._rows_only(base["grads"], rows), kept)
    return out


def readings(ctx, f64: bool = False) -> dict:
    from benchmark import system
    from benchmark.reference.neuralangelo import Faults
    from benchmark.traffic import train_window_hash as K

    p = K.build(ctx)
    first = K.first_steps(ctx, p)
    p["run"].release()
    for k in ("run", "state", "dpool", "fine_dgrid", "rows", "rgbs"):
        del p[k]
    system.free_device()
    out = {"weights": weight_readings(ctx, p)}
    ref = K.reference(ctx, p, first)
    rows, w = ref["rows"], p["weights"]
    sdf = ctx.cfg["NEUCONW"]["SDF_CONFIG"]
    out["program"] = K.numbers(first, ref, w, rows, sdf, True)
    out["losses"] = {"program": first["losses"], "reference": ref["losses"]}
    top = int(ctx.cfg["NEUCONW"]["SDF_CONFIG"]["levels"]) - 1
    sides = {"control": dict(prec_name=ctx.control),
             "levels_15": dict(faults=Faults(levels_short=1)),
             "mirrored_tap": dict(faults=Faults(mirrored=0)),
             "half_batch": dict(rows=ctx.traffic["batch"] // 2),
             "table_grad_zero": dict(faults=Faults(table_grad="zero")),
             "table_drop_0": dict(faults=Faults(table_grad="drop0")),
             f"table_drop_{top}": dict(faults=Faults(table_grad=f"drop{top}")),
             "table_shift": dict(faults=Faults(table_grad="shift"))}
    for name, kw in sides.items():
        other = K.reference(ctx, p, first, **kw)
        out[name] = K.numbers(other, ref, w, rows, sdf, True)
        del other
        system.free_device()
    kept = dict(first, params=dict(first["params"], **{K.TABLE: w[K.TABLE]}))
    out["table_unchanged"] = K.numbers(kept, ref, w, rows, sdf, True)
    if f64:
        out["f64"] = f64_readings(ctx, p, first, ref)
        system.free_device()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workload", default="train.neuralangelo")
    ap.add_argument("--f64", action="store_true", help="also against the float64 reference")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate_hash: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from benchmark import harness

    wl = harness.workload(harness.spec(), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(args.workload, wl, seed, 0.0, False, "cuda", t0)
        out = readings(ctx, args.f64)
        out.update(seed=seed, control_precision=ctx.control, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
