"""Rank programs for checking data parallelism (``parallel/mesh.py``): each
runs in a process that ``parallel.mesh.spawn`` started, joins the group,
does its part and writes what it saw to a file for the parent to compare.
They live in the port so that a spawned child imports no test module.

  * ``cli_rank``: ``tools/train_cli.run`` as one rank, then a resume from
    the last checkpoint; per-rank fingerprints of the parameters and the
    fine grid after each, and the rank's kernel launches and refreshes.
  * ``step_rank``: one data-parallel step of ``training/step.
    make_train_step`` on this rank's slice of a fixed global batch
    (``one_step``, which also runs the one-rank reference); the rank's
    reduced gradients, aux and updated parameters.
  * ``sweep_rank``: both sweeps of ``parallel/sweep.py`` through the group.
  * ``render_rank``: ``training/validation.render_image`` through the group.

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
    from ..ops import kernel_counters, read_launches
    from ..ops.sdf_mlp import fused_sdf_head
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
            for c in kernel_counters().values():
                c.launches = 0
            fused_sdf_head.launches_f32 = 0
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
