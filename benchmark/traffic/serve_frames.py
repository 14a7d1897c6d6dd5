"""Serving traffic: a closed loop of whole frames, as ``tools/render_cli
--dispatch scan`` renders them. Set-up makes the scene's SFM and fine
grids, ``frames`` seeded ring views of wh pixels with a seeded appearance
id each (host arrays, as the CLI builds them), loads the benchmark's
weights into the field and makes the served frame's graph
(``training/step.make_scan_render_fn``), which the first frame, rendered in
set-up, captures. The window renders frame after frame through
``training/validation.render_image`` (the rays to the card in one copy,
the chunks replayed, the images fetched to the host) until ``--seconds``
have passed; ``serve_rays_per_s`` is the frames' real pixels over the
window's seconds.

Parameters (``traffic/<mix>.json``): wh, chunk, frames (distinct views,
rendered in turn), check_frames and check_rays (the seeded sample of the
finished frames' rays held to the reference), trace_frames."""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import correct, system
from .. import scene as S
from ..reference import precision
from ..reference import render as ref_render
from ..weights import make_weights

REF_BLOCK = 8192  # rays a reference block


def build(ctx):
    from neuralrecon_w_tpu_torch.config import render_config_from_cfg
    from neuralrecon_w_tpu_torch.training.step import make_render_fn, make_scan_render_fn

    cfg, tr = ctx.cfg, ctx.traffic
    sfm, fine = system.scene_inputs(ctx)
    frames = [(rays.cpu().numpy(), a) for rays, a in
              S.serve_frames(tr["frames"], tr["wh"], cfg["assumed"]["cam_dist"],
                             cfg["NEUCONW"]["N_VOCAB"], ctx.generator("frames"))]
    ctx.lap("scene and frames")
    weights = make_weights(cfg, ctx.generator("weights"))
    fc, model = system.field(ctx, weights, train=False)
    ctx.sync()
    ctx.lap("weights and field")
    rcfg = render_config_from_cfg(ctx.port_cfg, sfm_level=sfm.level, fine_level=fine.level,
                                  nerf_far_override=bool(cfg["NEUCONW"]["NEAR_FAR_OVERRIDE"]))
    return {"sfm": sfm, "fine": fine, "frames": frames, "weights": weights, "model": model,
            "sfm_dgrid": system.device_grid(sfm), "fine_dgrid": system.device_grid(fine),
            "render_chunk": make_render_fn(fc, rcfg),
            "scan": make_scan_render_fn(fc, rcfg, tr["chunk"]), "scene": system.scene_info(ctx)}


def frame(ctx, p, i: int) -> dict:
    """Frame i of the loop (the views in turn), rendered and fetched."""
    from neuralrecon_w_tpu_torch.training.validation import render_image

    rays, a_id = p["frames"][i % len(p["frames"])]
    n = len(rays)
    with record_function("bench.frame"):
        return render_image(p["render_chunk"], p["model"], p["scene"], rays,
                            np.full(n, a_id, np.int32), np.zeros(n, np.int32), ctx.traffic["wh"],
                            ctx.traffic["chunk"], p["fine_dgrid"], p["sfm_dgrid"],
                            scan_render=p["scan"])


def sample(ctx, n_done: int) -> list:
    """(frame of the loop, ray indices) of the check, drawn from the seed."""
    tr = ctx.traffic
    g = ctx.generator("sample")
    n_rays = tr["wh"][0] * tr["wh"][1]
    k = min(tr["check_frames"], n_done)
    which = torch.randperm(n_done, generator=g, device=g.device)[:k].cpu().tolist()
    return [(f, torch.randperm(n_rays, generator=g, device=g.device)[:tr["check_rays"]].cpu())
            for f in sorted(which)]


def reference(ctx, p, picks: list, prec_name: str = "float32") -> list:
    """The reference's colour and depth of each pick's rays, in blocks."""
    cfg, dev = ctx.cfg, ctx.device
    st = system.settings(ctx, train=False)
    prec = precision.Precision(prec_name)
    out = []
    with prec.context(), torch.no_grad():
        for f, idx in picks:
            rays, a_id = p["frames"][f % len(p["frames"])]
            rays = torch.as_tensor(rays[idx.numpy()], device=dev)
            cs, ds = [], []
            for i in range(0, len(rays), REF_BLOCK):
                r = rays[i:i + REF_BLOCK]
                ts = torch.full((len(r),), a_id, dtype=torch.int32, device=dev)
                o = ref_render.render(p["weights"], cfg["NEUCONW"], prec, st, system.ref_scene(ctx),
                                      r, ts, torch.zeros_like(ts), None, 1.0, p["fine"], p["sfm"])
                cs.append(o["color"])
                ds.append(o["depth"])
            out.append((torch.cat(cs).cpu(), torch.cat(ds).cpu()))
    return out


def numbers(kept: list, picks: list, ref: list) -> dict:
    """The program's kept frames against the reference at the picked rays."""
    color = torch.cat([torch.as_tensor(kept[f]["color"].reshape(-1, 3))[idx] for f, idx in picks])
    depth = torch.cat([torch.as_tensor(kept[f]["depth"].reshape(-1))[idx] for f, idx in picks])
    return correct.serve_numbers(color, depth, torch.cat([c for c, _ in ref]),
                                 torch.cat([d for _, d in ref]))


def run(ctx) -> dict:
    tr = ctx.traffic
    p = build(ctx)
    frame(ctx, p, -1)  # the capture
    n_real = tr["wh"][0] * tr["wh"][1]
    chunks = -(-n_real // tr["chunk"])
    kept, failed, out = [], 0, {}
    ctx.sync()
    ctx.window_started()
    if not ctx.trace:
        t0 = time.perf_counter()
        marks = [t0]
        while True:
            img = frame(ctx, p, len(kept))
            kept.append({"color": img["color"], "depth": img["depth"]})
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= ctx.seconds:
                break
        elapsed = time.perf_counter() - t0
        ctx.walls("frame seconds", marks)
        out["e2e"] = {"serve_rays_per_s": n_real * len(kept) / elapsed}
    else:
        from torch.profiler import ProfilerActivity, profile

        from .. import trace as T

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.device.type == "cuda"
                                         else [])
        with profile(activities=acts) as prof:
            with record_function(T.WINDOW):
                for _ in range(tr["trace_frames"]):
                    img = frame(ctx, p, len(kept))
                    kept.append({"color": img["color"], "depth": img["depth"]})
                ctx.sync()
        out["rec"] = {"trace": T.from_profiler(prof), "chunks": chunks * len(kept),
                      "chunk": tr["chunk"], "rays": n_real * len(kept), "train": False}
    failed = sum(1 for k in kept if not (np.isfinite(k["color"]).all()
                                         and np.isfinite(k["depth"]).all()))
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(ctx.device)
                                if ctx.device.type == "cuda" else 0)
    p["scan"].release()
    for k in ("scan", "model", "render_chunk", "sfm_dgrid", "fine_dgrid"):
        del p[k]
    system.free_device()
    ctx.lap("window")
    picks = sample(ctx, len(kept))
    out["numbers"] = numbers(kept, picks, reference(ctx, p, picks))
    ctx.lap("reference")
    out.update(attempted=len(kept), failed=failed)
    return out
