"""Training traffic: the steady phase of one scene, as ``Trainer.fit``
drives it on the card. Set-up puts the configuration's ray pool on the
device (``datasets/cache.RayPool`` -> ``DeviceRayPool``), attaches the band
cache of the level-L fine grid (``DeviceRayPool.attach_surface``), loads the
benchmark's weights, builds Adam and the multi-step dispatch
(``training/step.make_scan_train_fn``, the ``ScanRun`` the Trainer calls),
and drives its first ``check_steps`` steps through that same call, one step
a call (the first an eager warm-up step, then the capture, then replays),
over consecutive windows of the epoch permutation (``take_scan_window``).
The window then runs dispatches of the configuration's ``TPU.SCAN_INNER``
steps, each followed by the read of its last loss (the Trainer's log),
until ``--seconds`` have passed; ``train_rays_per_s`` is batch x steps over
the window's seconds.

Parameters (``traffic/<mix>.json``): batch, views and wh (ring cameras of
the pool), check_steps, trace_steps (the steps of the traced dispatch)."""

from __future__ import annotations

import math
import time

import torch
from torch.profiler import record_function

from .. import correct, system
from .. import scene as S
from ..reference import precision
from ..reference import train as ref_train
from ..weights import make_weights

B1 = 0.9  # torch Adam's first-moment decay, the port's
TERMS = ("loss", "color_loss", "normal_loss", "mask_error", "sfm_depth_loss")  # the step's aux


def pool_seed(ctx) -> int:
    return ctx.prog_seed + 3


def jitter_draws(graph: bool, seed: int, step0: int, n_steps: int, batch: int, n_outside: int,
                 device) -> list:
    """The sampler's uniform draws of each step, as the program draws them:
    in a captured run from one generator seeded at capture with (seed,
    step0) (``ScanRun._capture``); in the plain loop from a generator a
    step seeded with (seed, step) (``step.step_generator``); the stream of
    torch's generator of that device."""
    out, g = [], None
    for i in range(n_steps):
        if g is None or not graph:
            step = step0 if graph else step0 + i
            g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)
        t = torch.rand(batch, 1, generator=g, device=device)
        z = torch.rand(batch, n_outside, generator=g, device=device) if n_outside else None
        out.append((t, z))
    return out


def epoch_rows(seed: int, n: int, batch: int, n_steps: int, device) -> list:
    """The rows of the first steps of the first epoch, as the pool's seed
    rule gives them (``DeviceRayPool._reshuffle``: one permutation an epoch
    from a generator seeded with seed x 1,000,003 + epoch; an unsharded
    pool's seed is its own), consecutive windows of the batch."""
    g = torch.Generator(device=device).manual_seed(seed * 1_000_003)
    perm = torch.randperm(n, generator=g, device=device)
    return [perm[i * batch:(i + 1) * batch].clone() for i in range(n_steps)]


def build(ctx):
    """The inputs and the system under test: (pieces dict)."""
    from neuralrecon_w_tpu_torch.config import render_config_from_cfg
    from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool, RayPool
    from neuralrecon_w_tpu_torch.training.losses import loss_config_from_cfg
    from neuralrecon_w_tpu_torch.training.schedule import make_optimizer
    from neuralrecon_w_tpu_torch.training.step import TrainState, make_scan_train_fn

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    n = cfg["NEUCONW"]
    _, fine = system.scene_inputs(ctx)
    rows, rgbs = S.training_rows(tr["views"], tr["wh"], cfg["assumed"]["cam_dist"],
                                 ctx.generator("rows"))
    pool = RayPool(rows.cpu().numpy(), rgbs.cpu().numpy(), with_semantics=True,
                   seed=ctx.prog_seed)
    dpool = DeviceRayPool(pool, dev, sampling=cfg["TPU"]["POOL_SAMPLING"], seed=pool_seed(ctx))
    del pool
    ctx.lap("scene and pool")
    fine_dgrid = system.device_grid(fine)
    dpool.attach_surface(fine_dgrid, fine.level)
    ctx.sync()
    ctx.lap("band cache")
    weights = make_weights(cfg, ctx.generator("weights"))
    fc, model = system.field(ctx, weights, train=True)
    ctx.sync()
    ctx.lap("weights and field")
    spec, _ = make_optimizer(ctx.port_cfg, tr["batch"])
    state = TrainState(model, spec.init(model.parameters()), 0)
    rcfg = render_config_from_cfg(ctx.port_cfg, sfm_level=-1, fine_level=fine.level,
                                  nerf_far_override=False)
    run = make_scan_train_fn(fc, rcfg, loss_config_from_cfg(ctx.port_cfg), int(n["ANNEAL_END"]),
                             system.label_ids(ctx, "RAY_MASK_LIST"), tr["batch"],
                             int(cfg["TPU"]["SCAN_INNER"]),
                             seed=ctx.prog_seed + 1)
    return {"rows": rows, "rgbs": rgbs, "dpool": dpool, "fine": fine, "fine_dgrid": fine_dgrid,
            "weights": weights, "state": state, "run": run, "scene": system.scene_info(ctx)}


def first_steps(ctx, p) -> dict:
    """The first check_steps steps through the window's own call, one step a
    call; what the check compares of them (losses, the first gradient from
    Adam's first moment, the parameters after them), the rows the program
    was fed, and the feed the reference takes: the rows of the pool's seed
    rule."""
    tr, dev = ctx.traffic, ctx.device
    run, state, dpool = p["run"], p["state"], p["dpool"]
    names = [k for k, _ in state.model.named_parameters()]
    inner, run.n_inner = run.n_inner, 1
    losses, idx, grads = [], [], None
    for i in range(tr["check_steps"]):
        perm, start = dpool.take_scan_window(tr["batch"], 1)
        idx.append(perm[start:start + tr["batch"]].clone())
        state, aux = run(state, p["scene"], dpool.data, p["fine_dgrid"], None, perm, start)
        losses.append({k: float(aux[k]) for k in TERMS if k in aux})
        if i == 0:
            opt = state.optimizer.opt
            grads = {k: (opt.state[q]["exp_avg"] / (1.0 - B1)).detach().clone()
                     if q in opt.state else torch.zeros_like(q)
                     for k, q in zip(names, state.model.parameters())}
    run.n_inner = inner
    params = {k: q.detach().clone() for k, q in state.model.named_parameters()}
    graph = run.captures_on(dev)
    rows, rgbs = p["rows"], p["rgbs"]
    want = epoch_rows(pool_seed(ctx), len(rows), tr["batch"], tr["check_steps"], dev)
    batches = [{"rays": torch.cat([rows[i, :8], rows[i, 10:12]], 1), "ts": rows[i, 8].int(),
                "labels": rows[i, 9].int(), "rgbs": rgbs[i]} for i in want]
    return {"losses": losses, "grads": grads, "params": params, "idx": idx, "want": want,
            "batches": batches, "graph": graph}


def reference(ctx, p, first: dict, prec_name: str = "float32", rows: int | None = None) -> dict:
    """The reference's same steps from the same weights, feed and jitter;
    with ``rows``, on the first rows of each batch only (a fault: the rest
    of the batch left out)."""
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    n = cfg["NEUCONW"]
    t = cfg["TRAINER"]
    jit = jitter_draws(first["graph"], ctx.prog_seed + 1, 0, tr["check_steps"], tr["batch"],
                       n["N_OUTSIDE"] if n["RENDER_BG"] else 0, dev)
    batches = first["batches"]
    if rows is not None:
        batches = [{k: v[:rows] for k, v in b.items()} for b in batches]
        jit = [(a[:rows], None if b is None else b[:rows]) for a, b in jit]
    prec = precision.Precision(prec_name)
    lr = t["CANONICAL_LR"] * tr["batch"] / t["CANONICAL_BS"]
    with prec.context():
        losses, grads, params = ref_train.steps(
            p["weights"], cfg, prec, system.settings(ctx, train=True), system.ref_scene(ctx),
            batches, jit, p["fine"], 0, lr, 1e-7, float(t["GRAD_CLIP"]),
            system.label_ids(ctx, "RAY_MASK_LIST"))
    return {"losses": losses, "grads": grads, "params": params, "idx": first["want"]}


def dispatch(ctx, p) -> float:
    """One dispatch of SCAN_INNER steps and the read of its last loss."""
    perm, start = p["dpool"].take_scan_window(ctx.traffic["batch"], p["run"].n_inner)
    with record_function("bench.dispatch"):
        p["state"], aux = p["run"](p["state"], p["scene"], p["dpool"].data, p["fine_dgrid"], None,
                                   perm, start)
    with record_function("bench.fetch"):
        return float(aux["loss"])


def run(ctx) -> dict:
    tr = ctx.traffic
    p = build(ctx)
    ctx.lap("optimiser and dispatch")
    first = first_steps(ctx, p)
    del p["rows"], p["rgbs"]
    attempted = failed = 0
    out = {}
    ctx.sync()
    ctx.window_started()
    if not ctx.trace:
        t0 = time.perf_counter()
        marks = [t0]
        while True:
            loss = dispatch(ctx, p)
            marks.append(time.perf_counter())
            attempted += p["run"].n_inner
            failed += 0 if math.isfinite(loss) else p["run"].n_inner
            if marks[-1] - t0 >= ctx.seconds:
                break
        ctx.sync()
        elapsed = time.perf_counter() - t0
        ctx.walls("dispatch seconds", marks)
        out["e2e"] = {"train_rays_per_s": tr["batch"] * attempted / elapsed}
    else:
        from torch.profiler import ProfilerActivity, profile

        from .. import trace as T

        p["run"].n_inner = tr["trace_steps"]
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.device.type == "cuda"
                                         else [])
        with profile(activities=acts) as prof:
            with record_function(T.WINDOW):
                loss = dispatch(ctx, p)
                ctx.sync()
        attempted = tr["trace_steps"]
        failed = 0 if math.isfinite(loss) else attempted
        out["rec"] = {"trace": T.from_profiler(prof), "steps": attempted, "batch": tr["batch"],
                      "train": True}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(ctx.device)
                                if ctx.device.type == "cuda" else 0)
    p["run"].release()
    for k in ("run", "state", "dpool", "fine_dgrid"):
        del p[k]
    system.free_device()
    ctx.lap("window")
    ref = reference(ctx, p, first)
    ctx.lap("reference")
    out["numbers"] = correct.train_numbers(first, ref, p["weights"])
    out.update(attempted=attempted, failed=failed)
    return out
