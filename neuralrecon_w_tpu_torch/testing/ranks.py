"""Rank programs for checking data and tensor parallelism (``parallel/mesh.py``,
``parallel/tensor.py``): each runs in a process that ``parallel.mesh.spawn``
started, joins the group, does its part and writes what it saw to a file
for the parent to compare. They live in the port so that a spawned child
imports no test module.

  * ``cli_rank``: ``tools/train_cli.run`` as one rank, then a resume from
    the last checkpoint; per-rank fingerprints of the parameters and the
    fine grid after each, and the rank's kernel launches and refreshes.
  * ``step_rank``: one data-parallel step of ``training/step.
    make_train_step`` on this rank's slice of a fixed global batch
    (``one_step``, which also runs the one-rank reference); the rank's
    reduced gradients, aux and updated parameters.
  * ``sweep_rank``: both sweeps of ``parallel/sweep.py`` through the group.
  * ``render_rank``: ``training/validation.render_image`` through the group.
  * ``tp_step_rank``: steps of ``make_train_step`` with the field split over
    the group's model axis (``tp_step``, which also runs the one-rank
    reference); per run the losses, the first step's gradients and the last
    parameters whole, the whole parameters' digests, the kernel launches,
    the walls and the model axis's traffic.
  * ``tp_render_rank``: ``render_image`` of a split or whole field through a
    group with a model axis.
  * ``tp_check_rank``: the collectives and ``tp_linear`` under ``gradcheck``
    and ``gradgradcheck`` in float64, the library's ``all_reduce`` in
    ``reduce``'s place, ``shard_field`` then ``gather_field``, and d sdf / d x
    with the eikonal term's gradient of a split SDF net against the whole.

``python -m neuralrecon_w_tpu_torch.testing.ranks OUT -- <train_cli flags>``
runs ``tools/train_cli.main`` in this process (one rank of a multi-process
group, ``--multihost``) and writes its fingerprint and ray count to OUT.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time

import numpy as np
import torch

from ..parallel.mesh import destroy, init_data_group


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def fingerprint(trainer) -> dict:
    """A trainer's state as digests: step, each parameter, the fine grid."""
    g = trainer.fine_grid_host
    return {"step": int(trainer.state.step),
            "params": {k: digest(v) for k, v in trainer.state.model.state_dict().items()},
            "fine_grid": None if g is None else {
                "level": int(g.level), "n_cells": int(len(g.coords)),
                "coords": hashlib.sha256(np.ascontiguousarray(g.coords).tobytes()).hexdigest()},
            "refreshes": trainer.refreshes}


def foreign_modules() -> list:
    """The modules of JAX or of the JAX package this process has loaded."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "neuralrecon_w_tpu"))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cli_rank(local_rank: int, argv: list, resume_argv: list, n_local: int, coordinator: str,
             out: str, backend=None, device=None) -> None:
    """``train_cli.run(argv)`` and then ``run(resume_argv)`` as rank
    ``local_rank`` of a one-host group; writes ``out.format(rank=...)``:
    per run its fingerprint, wall seconds, launches, whether the rank is
    main and its logger's path."""
    from ..ops import read_launches, reset_launches
    from ..tools.train_cli import get_opts, run

    if device is None and get_opts(argv).device == "cpu":
        device = "cpu"
    group = init_data_group(n_local, coordinator=coordinator, backend=backend, device=device,
                            local_rank=local_rank)
    rec = {"rank": group.rank, "world_size": group.world_size, "backend": group.backend,
           "foreign_modules": foreign_modules()}
    try:
        for name, a in (("run", argv), ("resume", resume_argv)):
            if a is None:
                continue
            reset_launches()
            _sync(group.device)
            t0 = time.perf_counter()
            tr = run(get_opts(a), group)
            _sync(group.device)
            rec[name] = {**fingerprint(tr), "seconds": time.perf_counter() - t0,
                         "launches": read_launches(), "is_main": tr.is_main,
                         "logger_path": tr.logger.path}
    finally:
        destroy(group)
    with open(out.format(rank=rec["rank"]), "w") as f:
        json.dump(rec, f)


def one_step(spec: dict, group=None) -> dict:
    """One step of ``make_train_step`` on ``spec``'s global batch (this
    rank's slice of it with a ``group``): ``spec`` holds the port's
    FieldConfig, RenderConfig and LossConfig ("fc", "rcfg", "lcfg"),
    "anneal_end", "mask_ids", "seed", "optimizer" (an OptimizerSpec), the
    model's "state_dict", the "batch" (numpy), "step", "scene" (origin,
    radius, sfm2gt as numpy), "device", and optionally "time_steps" (more
    steps on the same batch, timed) and "reduce_reps" (timed all-reduces of
    the step's flat buffer). Returns the step's gradients (reduced with a
    group), aux, the updated parameters, the walls and the all-reduce's
    size and time."""
    from ..models.neuconw import NeuconWField
    from ..parallel.mesh import all_reduce_sum_, shard_rays
    from ..rendering.renderer import SceneInfo
    from ..training.step import TrainState, make_train_step

    dev = torch.device(spec["device"]) if group is None else group.device
    model = NeuconWField(spec["fc"], dev)
    model.load_state_dict(spec["state_dict"])
    grads = {}

    class Keep:
        """The optimiser, before which the step's first gradients are kept."""

        def __init__(self):
            self.inner = spec["optimizer"].init(model.parameters())

        def zero_grad(self):
            model.zero_grad(set_to_none=True)

        def step(self):
            if not grads:
                grads.update({k: p.grad.detach().cpu().clone()
                              for k, p in model.named_parameters() if p.grad is not None})
            self.inner.step()

    state = TrainState(model, Keep(), int(spec.get("step", 0)))
    step = make_train_step(spec["fc"], spec["rcfg"], spec["lcfg"], spec["anneal_end"],
                           spec["mask_ids"], spec.get("seed", 0), group=group)
    scene = SceneInfo(*(torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
                        for v in spec["scene"]))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in shard_rays(group, spec["batch"]).items()}
    state, aux = step(state, scene, batch)
    aux = {k: float(v) for k, v in aux.items()}
    params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    walls = []
    for _ in range(int(spec.get("time_steps", 0))):
        _sync(dev)
        t0 = time.perf_counter()
        step(state, scene, batch)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    # the step's flat buffer: every gradient, and the aux parts (the terms,
    # s_val and psnr's two)
    numel = sum(g.numel() for g in grads.values()) + len(aux) + 1
    reduce_ms = None
    if group is not None and spec.get("reduce_reps"):
        buf = torch.ones(numel, device=dev)
        all_reduce_sum_(group, buf)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(int(spec["reduce_reps"])):
            all_reduce_sum_(group, buf)
        _sync(dev)
        reduce_ms = (time.perf_counter() - t0) * 1e3 / int(spec["reduce_reps"])
    return {"grads": grads, "aux": aux, "params": params, "walls": walls,
            "reduce_numel": numel, "reduce_ms": reduce_ms}


def step_rank(local_rank: int, n_local: int, coordinator: str, spec: dict, out: str) -> None:
    """``one_step`` as rank ``local_rank`` of a one-host group ("backend"
    in ``spec``, else the device's); writes ``out.format(rank=...)`` with
    torch.save."""
    group = init_data_group(n_local, coordinator=coordinator, backend=spec.get("backend"),
                            device=spec["device"], local_rank=local_rank)
    try:
        rec = {"rank": group.rank, "backend": group.backend, **one_step(spec, group)}
        torch.save(rec, out.format(rank=group.rank))
    finally:
        destroy(group)


def sweep_rank(local_rank: int, n_local: int, coordinator: str, spec: dict, out: str) -> None:
    """``sharded_sdf_sweep`` and ``sharded_rgb_sweep`` of ``spec``'s model
    ("fc", "state_dict") at "pts" through the group; "chunk", "macro",
    "device". Writes ``out.format(rank=...)`` (npz: sdf, rgb)."""
    from ..models.neuconw import NeuconWField
    from ..parallel.sweep import sharded_rgb_sweep, sharded_sdf_sweep

    dev = torch.device(spec["device"])
    group = init_data_group(n_local, coordinator=coordinator, device=dev, local_rank=local_rank)
    try:
        model = NeuconWField(spec["fc"], dev)
        model.load_state_dict(spec["state_dict"])
        model.eval().requires_grad_(False)
        kw = {"chunk": spec["chunk"], "macro": spec["macro"], "group": group}
        sdf = sharded_sdf_sweep(model, spec["fc"], spec["pts"], **kw)
        rgb = sharded_rgb_sweep(model, spec["fc"], spec["pts"], spec["view_dir"],
                                spec["a_index"], **kw)
        np.savez(out.format(rank=group.rank), sdf=sdf, rgb=rgb)
    finally:
        destroy(group)


def render_rank(local_rank: int, n_local: int, coordinator: str, spec: dict, out: str) -> None:
    """``render_image`` of ``spec``'s model ("fc", "rcfg", "state_dict") on
    "rays", "ts", "labels" (numpy), "wh", "chunk", "scene", "device" through
    the group. Writes ``out.format(rank=...)`` (npz: color, depth, normal)."""
    from ..models.neuconw import NeuconWField
    from ..rendering.renderer import SceneInfo
    from ..training.step import make_render_fn
    from ..training.validation import render_image

    dev = torch.device(spec["device"])
    group = init_data_group(n_local, coordinator=coordinator, device=dev, local_rank=local_rank)
    try:
        model = NeuconWField(spec["fc"], dev)
        model.load_state_dict(spec["state_dict"])
        model.eval().requires_grad_(False)
        scene = SceneInfo(*(torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
                            for v in spec["scene"]))
        img = render_image(make_render_fn(spec["fc"], spec["rcfg"]), model, scene, spec["rays"],
                           spec["ts"], spec["labels"], spec["wh"], spec["chunk"], group=group)
        np.savez(out.format(rank=group.rank), **img)
    finally:
        destroy(group)


def whole_grads(model) -> dict:
    """Every parameter's gradient (zeros where none), a split one gathered."""
    from ..parallel.tensor import all_gather_raw

    out = {}
    for k, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        s = getattr(p, "tp", None)
        out[k] = (g if s is None else all_gather_raw(g, s.axis, s.dim)).detach().cpu().clone()
    return out


def tp_step(spec: dict, group=None) -> dict:
    """``spec["runs"]``, each {"label", "fc", "n_steps"} and optionally its
    own "rcfg": from ``spec``'s
    state dict, ``n_steps`` steps of ``make_train_step`` on its fixed batch
    (this rank's data slice), the field split over ``group``'s model axis
    (whole without a group). ``spec`` holds ``one_step``'s keys but "fc" and
    "time_steps". Returns per run label: the losses, the first step's
    gradients and the last parameters (whole, the reference's names), the
    whole parameters' digests and their gradients' digests before
    ``sync_replicated_grads``, the kernel launches, each step's wall and
    the model axis's traffic in the last step."""
    from ..models.neuconw import NeuconWField
    from ..ops import read_launches
    from ..parallel import tensor as tp
    from ..parallel.mesh import shard_rays
    from ..rendering.renderer import SceneInfo
    from ..training import step as step_mod

    dev = torch.device(spec["device"]) if group is None else group.device
    scene = SceneInfo(*(torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
                        for v in spec["scene"]))
    sync = step_mod.sync_replicated_grads
    res = {}
    for run in spec["runs"]:
        fc = run["fc"]
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in shard_rays(group, spec["batch"]).items()}
        model = NeuconWField(fc, dev)
        model.load_state_dict(spec["state_dict"])
        if group is not None:
            tp.shard_field(model, group)
        names = {id(p): k for k, p in model.named_parameters()}
        grads, pre_sync = {}, {}

        class Keep:
            def __init__(self):
                self.inner = spec["optimizer"].init(model.parameters())

            def zero_grad(self):
                model.zero_grad(set_to_none=True)

            def step(self):
                if not grads:
                    grads.update(whole_grads(model))
                self.inner.step()

        def recording(g, params):
            params = list(params)
            if not pre_sync:
                pre_sync.update({names[id(p)]: digest(p.grad) for p in params
                                 if p.grad is not None and getattr(p, "tp", None) is None})
            sync(g, params)

        rcfg = run.get("rcfg", spec["rcfg"])
        step = step_mod.make_train_step(fc, rcfg, spec["lcfg"], spec["anneal_end"],
                                        spec["mask_ids"], spec.get("seed", 0), group=group)
        state = step_mod.TrainState(model, Keep(), int(spec.get("step", 0)))
        before = read_launches()
        losses, walls = [], []
        step_mod.sync_replicated_grads = recording
        try:
            for _ in range(int(run["n_steps"])):
                tp.traffic(reset=True)
                _sync(dev)
                t0 = time.perf_counter()
                state, aux = step(state, scene, batch)
                _sync(dev)
                walls.append(time.perf_counter() - t0)
                losses.append(float(aux["loss"]))
        finally:
            step_mod.sync_replicated_grads = sync
        whole = tp.gather_field(model) if group is not None else model
        res[run["label"]] = {
            "losses": losses, "grads": grads, "walls": walls, "traffic": tp.traffic(),
            "params": {k: v.detach().cpu().clone() for k, v in whole.state_dict().items()},
            "whole_digests": {k: digest(p) for k, p in model.named_parameters()
                              if getattr(p, "tp", None) is None},
            "pre_sync_digests": pre_sync,
            "launches": {k: v - before[k] for k, v in read_launches().items()}}
        del model, state, whole
    return res


def tp_step_rank(local_rank: int, n_local: int, n_model: int, coordinator: str, spec: dict,
                 out: str) -> None:
    """``tp_step`` as rank ``local_rank`` of a one-host group with a model
    axis of ``n_model`` ("backend" in ``spec``, else the device's), then,
    with "wire_mb" in ``spec``, ``wire_times``; writes
    ``out.format(rank=...)`` with torch.save."""
    group = init_data_group(n_local, coordinator=coordinator, backend=spec.get("backend"),
                            device=spec["device"], local_rank=local_rank, n_model=n_model)
    try:
        rec = {"rank": group.rank, "data_rank": group.data_rank,
               "model_rank": group.model_rank, "foreign_modules": foreign_modules(),
               **tp_step(spec, group)}
        if spec.get("wire_mb"):
            rec["wire"] = wire_times(group, spec["wire_mb"], spec.get("wire_reps", 3))
        torch.save(rec, out.format(rank=group.rank))
    finally:
        destroy(group)


def wire_times(group, mb: float, reps: int) -> dict:
    """The model axis's all-reduce of ``mb`` MB and all-gather of ``mb`` MB
    in all (the ranks' equal parts), each timed over ``reps`` calls after
    one untimed: {"mb", "all_reduce", "all_gather"} in MB and ms a call."""
    from ..parallel import tensor as tp

    axis = tp.model_axis(group)
    n = int(mb * 1e6 / 4) // axis.n * axis.n
    whole = torch.ones(n, device=group.device)
    part = torch.ones(n // axis.n, device=group.device)
    got = {"mb": n * 4 / 1e6}
    for name, fn in (("all_reduce", lambda: tp.all_reduce_raw(whole, axis)),
                     ("all_gather", lambda: tp.all_gather_raw(part, axis, 0))):
        fn()
        _sync(group.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(group.device)
        got[name] = (time.perf_counter() - t0) * 1e3 / reps
    tp.traffic(reset=True)
    return got


def tp_render_rank(local_rank: int, n_local: int, n_model: int, coordinator: str, spec: dict,
                   out: str) -> None:
    """``render_rank`` through a group with a model axis of ``n_model``, the
    field split over it when ``spec["split"]``."""
    from ..models.neuconw import NeuconWField
    from ..parallel.tensor import shard_field
    from ..rendering.renderer import SceneInfo
    from ..training.step import make_render_fn
    from ..training.validation import render_image

    dev = torch.device(spec["device"])
    group = init_data_group(n_local, coordinator=coordinator, device=dev, local_rank=local_rank,
                            n_model=n_model)
    try:
        model = NeuconWField(spec["fc"], dev)
        model.load_state_dict(spec["state_dict"])
        if spec["split"]:
            shard_field(model, group)
        model.eval().requires_grad_(False)
        scene = SceneInfo(*(torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
                            for v in spec["scene"]))
        img = render_image(make_render_fn(spec["fc"], spec["rcfg"]), model, scene, spec["rays"],
                           spec["ts"], spec["labels"], spec["wh"], spec["chunk"], group=group)
        np.savez(out.format(rank=group.rank), **img)
    finally:
        destroy(group)


def _collective_pairs(axis):
    """The four collectives in the pairs that make a function of a whole
    input whole again (each rank's part scaled by its own factor), by name."""
    from ..parallel import tensor as tp

    c = 0.7 * (axis.rank + 1)
    return {
        ("copy", "gather"): lambda x: tp.gather(torch.tanh(tp.copy(x, axis) * c), axis),
        ("split", "gather"): lambda x: tp.gather(torch.tanh(tp.split(x, axis) * c), axis),
        ("split", "reduce"): lambda x: tp.reduce(torch.tanh(tp.split(x, axis) * c), axis),
        ("copy", "reduce"): lambda x: tp.reduce(torch.tanh(tp.copy(x, axis) * c), axis),
    }


def _linear_fn(axis, kind: str, weight_norm: bool):
    """tp_linear of a layer made of whole (x, weight, [g,] bias) inputs, its
    rank's blocks taken by ``split``: a function whole in, whole out. The
    input comes as two column blocks, and the product is scaled by 0.8."""
    from types import SimpleNamespace

    from ..models.layers import tp_linear
    from ..parallel import tensor as tp

    dim = 1 if kind == "row" else 0

    def blk(t, d):
        return tp.split(t, axis, d) if kind == "col" or d == 1 else t

    def fn(x, w, *rest):
        if weight_norm:
            g, b = rest
            layer = SimpleNamespace(weight_v=tp.split(w, axis, dim), weight_g=blk(g, 0),
                                    bias=blk(b, 0))
            layer.weight_v.tp = tp.Split(kind, dim, axis)
        else:
            (b,) = rest
            layer = SimpleNamespace(weight=tp.split(w, axis, dim), bias=blk(b, 0))
            layer.weight.tp = tp.Split(kind, dim, axis)
        return tp_linear(layer, (x[:, :3], x[:, 3:]), scale=0.8)

    return fn


def tp_check_rank(local_rank: int, n_local: int, coordinator: str, spec: dict,
                  out: str) -> None:
    """The float64 checks of ``parallel/tensor.py`` on ``n_local`` model
    ranks of one data shard (gloo on the CPU); writes ``out.format(rank=)``
    with torch.save: per collective pair and per ``tp_linear`` kind whether
    ``gradcheck`` and ``gradgradcheck`` pass, the library all-reduce's
    gradients against ``reduce``'s, ``shard_field`` + ``gather_field``
    against the state dict, and d sdf / d x and the eikonal term's
    gradient of the split SDF net of ``spec`` ("fc", "state_dict", "pts")
    against the whole one's."""
    import torch.distributed.nn.functional as dist_nn
    from torch.autograd import gradcheck, gradgradcheck

    from ..models.neuconw import NeuconWField
    from ..models.sdf import sdf_value_feat_grad
    from ..parallel import tensor as tp

    group = init_data_group(n_local, coordinator=coordinator, device="cpu",
                            local_rank=local_rank, n_model=n_local)
    axis = tp.model_axis(group)
    gen = torch.Generator().manual_seed(0)  # every rank draws the same whole inputs

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64).requires_grad_(True)

    try:
        rec = {"rank": group.rank, "checks": {}}
        for pair, fn in _collective_pairs(axis).items():
            x = rand(3, 4 * n_local)
            rec["checks"][pair] = (gradcheck(fn, (x,), raise_exception=False),
                                   gradgradcheck(fn, (x,), raise_exception=False))
        for kind in ("col", "row"):
            for wn in (True, False):
                args = (rand(3, 8), rand(4 * n_local, 8)) + (
                    (rand(4 * n_local, 1), rand(4 * n_local)) if wn else (rand(4 * n_local),))
                fn = _linear_fn(axis, kind, wn)
                rec["checks"][(kind, "wn" if wn else "plain")] = (
                    gradcheck(fn, args, raise_exception=False),
                    gradgradcheck(fn, args, raise_exception=False))
        # the library all-reduce in reduce's place: its backward all-reduces too
        x, w, b = rand(3, 8), rand(4 * n_local, 8), rand(4 * n_local)
        fn = _linear_fn(axis, "row", False)
        grads, reduce = {}, tp.reduce
        for name, red in (("reduce", reduce),
                          ("library", lambda t, a: dist_nn.all_reduce(t, group=a.pg))):
            tp.reduce = red
            try:
                y = fn(x, w, b)
                grads[name] = torch.autograd.grad((y * y).sum(), (x, w))
            finally:
                tp.reduce = reduce
        rec["library_ratio"] = [float(torch.linalg.vector_norm(a) / torch.linalg.vector_norm(r))
                                for a, r in zip(grads["library"], grads["reduce"])]
        # shard_field then gather_field, and the split SDF net against the whole
        model = NeuconWField(spec["fc"], "cpu")
        model.load_state_dict(spec["state_dict"])
        whole = NeuconWField(spec["fc"], "cpu")
        whole.load_state_dict(spec["state_dict"])
        tp.shard_field(model, group)
        back = tp.gather_field(model).state_dict()
        rec["roundtrip_equal"] = all(torch.equal(back[k], v) for k, v in
                                     spec["state_dict"].items()) and set(back) == set(
            spec["state_dict"])
        got = []
        for m in (whole, model):
            net = m.neuconw.sdf_net
            pts = torch.as_tensor(spec["pts"])
            _, _, grad = sdf_value_feat_grad(net, spec["fc"].sdf_cfg, pts, create_graph=True)
            eik = torch.mean((torch.linalg.vector_norm(grad, dim=-1) - 1.0) ** 2)
            eik.backward()
            got.append((grad.detach(), whole_grads(net)))
        rec["dsdf_dx_err"] = float((got[0][0] - got[1][0]).abs().max())
        rec["eikonal_grad_err"] = max(float((got[0][1][k] - got[1][1][k]).abs().max())
                                      for k in got[0][1])
        torch.save(rec, out.format(rank=group.rank))
    finally:
        destroy(group)


def main(argv=None) -> None:
    from ..tools.train_cli import main as train_main

    argv = sys.argv[1:] if argv is None else argv
    out, rest = argv[0], argv[argv.index("--") + 1:]
    tr = train_main(rest)
    with open(out, "w") as f:
        json.dump({**fingerprint(tr), "n_rays": len(tr.load_rays()), "is_main": tr.is_main,
                   "logger_path": tr.logger.path, "foreign_modules": foreign_modules()}, f)


if __name__ == "__main__":
    main()
