#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, over many
seeds in one process (set-up is most of a run):

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]

For each seed it drives the cell's timed path as a run does (training: the
first steps through the dispatch's own call; serving: ``frames`` frames
through ``render_image`` and the served graph) and prints one JSON line:
the program's numbers against the float32 reference ("program"), the
control's, the reference computed in the precision below the
configuration's put in the program's place ("control"), and for training
the fault "half of the batch left out, the mean taken over the rest",
planted in the reference put in the program's place ("half_batch"). The
benchmark's runs do not run this."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def leaf_table(prog: dict, ref: dict, params0: dict) -> dict:
    """Each leaf's norms of the first gradient and of the change: the
    reference's, the other side's and their difference's (the readings a
    per-leaf number is worked out from)."""
    def norm(t):
        return float(t.double().norm())

    out = {"grad": {}, "change": {}}
    for k in ref["grads"]:
        a, b = prog["grads"][k], ref["grads"][k]
        out["grad"][k] = [norm(b), norm(a), norm(a.double() - b.double())]
        da = prog["params"][k].double() - params0[k].double()
        db = ref["params"][k].double() - params0[k].double()
        out["change"][k] = [norm(db), norm(da), norm(da - db)]
    return out


def train_readings(ctx) -> dict:
    from benchmark import correct, system
    from benchmark.traffic import train_window as K

    p = K.build(ctx)
    first = K.first_steps(ctx, p)
    p["run"].release()
    for k in ("run", "state", "dpool", "fine_dgrid", "rows", "rgbs"):
        del p[k]
    system.free_device()
    ref = K.reference(ctx, p, first)
    ctl = K.reference(ctx, p, first, ctx.control)
    hb = K.reference(ctx, p, first, rows=ctx.traffic["batch"] // 2)
    w = p["weights"]
    return {"program": correct.train_numbers(first, ref, w),
            "leaves": {"program": leaf_table(first, ref, w), "control": leaf_table(ctl, ref, w),
                       "half_batch": leaf_table(hb, ref, w)},
            "control": correct.train_numbers(ctl, ref, w),
            "half_batch": correct.train_numbers(hb, ref, w),
            "losses": {"program": first["losses"], "reference": ref["losses"],
                       "control": ctl["losses"]},
            "worst": {"program": correct.worst_leaves(first, ref, w),
                      "control": correct.worst_leaves(ctl, ref, w)}}


def serve_readings(ctx, n_frames: int) -> dict:
    import torch

    from benchmark import correct, system
    from benchmark.traffic import serve_frames as K

    p = K.build(ctx)
    kept = []
    for i in range(n_frames + 1):
        img = K.frame(ctx, p, i - 1)
        if i:
            kept.append({"color": img["color"], "depth": img["depth"]})
    p["scan"].release()
    for k in ("scan", "model", "render_chunk", "sfm_dgrid", "fine_dgrid"):
        del p[k]
    system.free_device()
    picks = K.sample(ctx, len(kept))
    ref = K.reference(ctx, p, picks)
    ctl = K.reference(ctx, p, picks, ctx.control)

    def cat(outs, i):
        return torch.cat([o[i] for o in outs])

    return {"program": K.numbers(kept, picks, ref),
            "control": correct.serve_numbers(cat(ctl, 0), cat(ctl, 1), cat(ref, 0), cat(ref, 1))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=2, help="serving: frames a seed")
    ap.add_argument("--control", help="the control's precision (default: the cell file's)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from benchmark import harness

    sp = harness.spec()
    wl = harness.workload(sp, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(args.workload, wl, seed, 0.0, False, "cuda", t0)
        ctx.control = args.control or ctx.control
        kind = ctx.traffic["kind"]
        out = (train_readings(ctx) if kind == "train_window"
               else serve_readings(ctx, args.frames))
        out.update(seed=seed, control_precision=ctx.control, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
