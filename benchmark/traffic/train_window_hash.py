"""Training traffic of a hash-grid SDF field (``configs/neuralangelo_op.json``):
``train_window``'s steady phase, as ``Trainer.fit`` drives it on the card,
at the step ``step`` of the coarse-to-fine schedule (all levels active at
the published schedule's 60,000). Set-up puts the ray pool on the device
with its band cache, loads the benchmark's steady-state weights
(``weights_hash``), builds AdamW and the multi-step dispatch, and drives
the first ``check_steps`` steps through that call, one step a call; the
window runs dispatches of ``TPU.SCAN_INNER`` steps, each followed by the
read of its last loss; ``train_rays_per_s`` is batch x steps over the
window's seconds. The check holds the steps to the hash-grid reference
(``reference/neuralangelo.py``), the table's leaf taken over the rows the
steps' gradients reached, and that leaf's gradient and change on their
own. A traced run adds, for the rooflines, the table
entries the first step's encodings touched (the reference's record).

Parameters (``traffic/<mix>.json``): batch, views, wh, check_steps,
trace_steps, as ``train_window``'s, and step."""

from __future__ import annotations

import math
import time

import torch
from torch.profiler import record_function

from .. import correct, system
from .. import scene as S
from ..reference import hashgrid as H
from ..reference import neuralangelo as ref_hash
from ..reference import precision
from ..weights_hash import make_weights
from .train_window import B1, dispatch, epoch_rows, jitter_draws, pool_seed

TERMS = ("loss", "color_loss", "normal_loss", "curvature_loss", "mask_error", "sfm_depth_loss")
TABLE = f"{H.SDF}table"

# a tiny scene and field for the CPU tests (6 levels, 2^12 entries, MLP 1 x 32)
TINY_CFG = {"assumed": {"sfm_points": 2000, "sfm_voxel": 0.2, "fine_level": 5},
            "NEUCONW": {"SDF_CONFIG": {"levels": 6, "log2_table": 12, "min_res": 4,
                                       "max_res": 64, "d_hidden": 32, "d_out": 33},
                        "COLOR_CONFIG": {"d_feature": 32, "d_hidden": 32, "n_layers": 2,
                                         "head_channels": 16},
                        "N_VOCAB": 16},
            "TPU": {"SCAN_INNER": 2}}
TINY_TRAFFIC = {"batch": 512, "views": 8, "wh": [16, 12], "trace_steps": 2}


def lr_of(cfg: dict, batch: int) -> float:
    t = cfg["TRAINER"]
    return float(t["LR"]) if t.get("LR") is not None else \
        t["CANONICAL_LR"] * batch / t["CANONICAL_BS"]


def build(ctx):
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
    state = TrainState(model, spec.init(model.parameters()), int(tr["step"]))
    rcfg = render_config_from_cfg(ctx.port_cfg, sfm_level=-1, fine_level=fine.level,
                                  nerf_far_override=False)
    run = make_scan_train_fn(fc, rcfg, loss_config_from_cfg(ctx.port_cfg), int(n["ANNEAL_END"]),
                             system.label_ids(ctx, "RAY_MASK_LIST"), tr["batch"],
                             int(cfg["TPU"]["SCAN_INNER"]), seed=ctx.prog_seed + 1)
    return {"rows": rows, "rgbs": rgbs, "dpool": dpool, "fine": fine, "fine_dgrid": fine_dgrid,
            "weights": weights, "state": state, "run": run, "scene": system.scene_info(ctx)}


def first_steps(ctx, p) -> dict:
    """``train_window.first_steps`` with this field's loss terms: the first
    check_steps steps through the window's own call, one step a call."""
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


def reference(ctx, p, first: dict, prec_name: str = "float32", rows: int | None = None,
              faults=ref_hash.Faults(), record: bool = False, dtype=None) -> dict:
    """The reference's same steps from the same weights, feed and jitter;
    with ``rows``, on the first rows of each batch only (a fault); with
    ``faults``, the encoding's, the taps' or the table gradient's
    (``reference/neuralangelo``); with ``dtype`` (float64), the weights,
    rays and jitter cast to it."""
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    n = cfg["NEUCONW"]
    t = cfg["TRAINER"]
    jit = jitter_draws(first["graph"], ctx.prog_seed + 1, int(tr["step"]), tr["check_steps"],
                       tr["batch"], n["N_OUTSIDE"] if n["RENDER_BG"] else 0, dev)
    batches = first["batches"]
    if rows is not None:
        batches = [{k: v[:rows] for k, v in b.items()} for b in batches]
        jit = [(a[:rows], None if b is None else b[:rows]) for a, b in jit]
    weights = p["weights"]
    if dtype is not None:
        def cast(t):
            return t.to(dtype) if t is not None and t.is_floating_point() else t

        weights = {k: cast(v) for k, v in weights.items()}
        batches = [{k: cast(v) for k, v in b.items()} for b in batches]
        jit = [(cast(a), cast(b)) for a, b in jit]
    prec = precision.Precision(prec_name)
    with prec.context():
        losses, grads, params, touched, rec = ref_hash.steps(
            weights, cfg, prec, system.settings(ctx, train=True), system.ref_scene(ctx),
            batches, jit, p["fine"], int(tr["step"]), lr_of(cfg, tr["batch"]),
            float(t["WEIGHT_DECAY"]), 1e-7, float(t["GRAD_CLIP"]),
            system.label_ids(ctx, "RAY_MASK_LIST"), faults, record)
    return {"losses": losses, "grads": grads, "params": params, "idx": first["want"],
            "rows": touched, "record": rec}


def _rows_only(d: dict, rows) -> dict:
    return {k: (v[rows] if k == TABLE else v) for k, v in d.items()}


def unit_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's distance between the two gradients' directions, |g_p /
    |g_p| - g_r / |g_r||: blind to a common scale. The global-norm clip
    scales every leaf by the step's one norm, and this field's curvature
    term moves that norm by a few % where a sample's Laplacian, a
    difference of five sdf values over e^2, changes sign between two
    roundings; a direction moves only where the work differs."""
    def unit(t):
        t = t.double()
        return t / max(float(torch.linalg.vector_norm(t)), 1e-30)

    return {k: float(torch.linalg.vector_norm(unit(prog[k]) - unit(ref[k]))) for k in keys}


def _row_gaps(a, b):
    """Each row's |a_r - b_r| / |b_r| (a row: an entry's F features)."""
    a, b = a.double(), b.double()
    return torch.linalg.vector_norm(a - b, dim=1) / \
        torch.linalg.vector_norm(b, dim=1).clamp_min(1e-300)


def table_numbers(prog: dict, other: dict, w0: dict, rows, sdf: dict,
                  per_level: bool = False) -> dict:
    """The table's own numbers, its leaf over ``rows`` in ``prog``,
    ``other`` and ``w0`` (K14's scatter-add and the table's update: one
    leaf of ~60 in the medians). Over the whole leaf: ``table_grad_unit_gap``,
    ``unit_gaps`` of its first gradient, and ``table_change_gap``, |d_p -
    d_r| / |d_r| of its change d over the steps. By level, each the
    largest over the levels: ``table_level_unit_gap``, ``unit_gaps`` of the
    level's first gradient; ``table_rows_grad_gap`` and
    ``table_rows_change_gap``, the median over the level's rows of each
    row's gap of the first gradient (the rows the reference's first step
    reached) and of the change. With ``per_level``, each level's too."""
    g_p, g_r = prog["grads"][TABLE], other["grads"][TABLE]
    d_p, d_r = (d["params"][TABLE].double() - w0[TABLE].double() for d in (prog, other))
    out = {"table_grad_unit_gap": unit_gaps({TABLE: g_p}, {TABLE: g_r}, [TABLE])[TABLE],
           "table_change_gap": correct.leaf_dir_gaps({TABLE: d_p}, {TABLE: d_r}, [TABLE])[TABLE]}
    starts = torch.tensor([off for _, off, _ in H.layout(sdf)], device=rows.device)
    level = torch.searchsorted(starts, rows, right=True) - 1
    first = torch.linalg.vector_norm(g_r.double(), dim=1) > 0
    grad_gap, change_gap = _row_gaps(g_p, g_r), _row_gaps(d_p, d_r)
    levels = {"unit": [], "rows_grad": [], "rows_change": []}
    for l in range(len(starts)):
        at, at_first = level == l, (level == l) & first
        if not bool(at_first.any()):
            continue
        levels["unit"].append(unit_gaps({TABLE: g_p[at]}, {TABLE: g_r[at]}, [TABLE])[TABLE])
        levels["rows_grad"].append(float(grad_gap[at_first].median()))
        levels["rows_change"].append(float(change_gap[at].median()))
    out.update(table_level_unit_gap=max(levels["unit"]),
               table_rows_grad_gap=max(levels["rows_grad"]),
               table_rows_change_gap=max(levels["rows_change"]))
    if per_level:
        out["table_levels"] = levels
    return out


def numbers(first: dict, ref: dict, weights: dict, rows, sdf: dict,
            per_level: bool = False) -> dict:
    """``correct.train_numbers`` with the table's leaf taken over ``rows``
    (the rows the float32 reference's gradients reached), and
    ``grad_unit_median_gap``: the median over the leaves the change keeps
    (``correct.kept_leaves``) of ``unit_gaps`` of the first gradient; and
    the table's own (``table_numbers``, ``sdf`` its layout)."""
    w0 = _rows_only(weights, rows)
    prog = dict(first, grads=_rows_only(first["grads"], rows),
                params=_rows_only(first["params"], rows))
    other = dict(ref, grads=_rows_only(ref["grads"], rows), params=_rows_only(ref["params"], rows))
    out = correct.train_numbers(prog, other, w0)
    gaps = unit_gaps(prog["grads"], other["grads"], correct.kept_leaves(other["grads"]))
    out["grad_unit_median_gap"] = sorted(gaps.values())[len(gaps) // 2]
    out.update(table_numbers(prog, other, w0, rows, sdf, per_level))
    return out


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
    ref = reference(ctx, p, first, record=ctx.trace)
    ctx.lap("reference")
    if ctx.trace:
        rec = ref["record"]
        out["rec"]["hash"] = {"touched_all": int(rec.all.sum()),
                              "touched_grad": int(rec.grad.sum())}
    out["numbers"] = numbers(first, ref, p["weights"], ref["rows"],
                             ctx.cfg["NEUCONW"]["SDF_CONFIG"])
    out.update(attempted=attempted, failed=failed)
    return out
