#!/usr/bin/env python3
"""The port's Trainer beside the JAX package's on the CPU, over chip_smoke's
trainer schedule: the operating point's loss weights, learning-rate rule
and sampling (``config/train_brandenburg_gate_tpu.yaml``) at a narrow
width in float32, a refresh every 20 steps, 61 steps so that the refreshes
at 20, 40 and 60 all run, PERTURB 0 and the host ray pool. The port starts
from the JAX initialisation carried across.

    JAX_PLATFORMS=cpu python3 scripts/torch_trainer_vs_jax.py [--steps 61]

The workspace is chip_smoke's (``cli_workspace``: the port's synthetic
scene, SFM points on the unit sphere, the scene radius 1.2 x the camera
distance) at 12 + 1 views of 40x30 and a coarse SFM grid. At every refresh
it prints each package's kept share, the cells one keeps and the other
does not, and the median SDF at the SFM points (the zero set's level
shift); then the logged losses and validations (PSNR, inline mesh
F-score, every ``--val`` steps) of both at the steps both log. It imports
both packages and is no part of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

BATCH = 512
NARROW = {"SDF_CONFIG": {"d_hidden": 64, "d_out": 65, "n_layers": 4, "skip_in": [2]},
          "COLOR_CONFIG": {"d_feature": 64, "d_hidden": 32, "n_layers": 2, "head_channels": 16},
          "N_VOCAB": 16, "PERTURB": 0.0}
CAMS, WH, POINTS, CAM_DIST = 12, (40, 30), 4000, 1.7  # the 4 x 64 init crosses near |x| 0.5
SFM_VOXEL, TRAIN_VOXEL = 0.1875, 0.05


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=61)
    parser.add_argument("--update", type=int, default=20)
    parser.add_argument("--val", type=int, default=10, help="steps between validations")
    args = parser.parse_args()
    import jax
    import numpy as np
    import torch

    from neuralrecon_w_tpu.config import get_cfg_defaults
    from neuralrecon_w_tpu.parallel.mesh import make_mesh
    from neuralrecon_w_tpu.parallel.sweep import sharded_sdf_sweep as jax_sweep
    from neuralrecon_w_tpu.training import loop as jax_loop
    from neuralrecon_w_tpu.training.schedule import scaled_lr as jax_scaled_lr
    from neuralrecon_w_tpu_torch.config import load_cfg
    from neuralrecon_w_tpu_torch.datasets.colmap import read_points3d_binary
    from neuralrecon_w_tpu_torch.parallel.sweep import sharded_sdf_sweep
    from neuralrecon_w_tpu_torch.tools.convert import state_from_jax
    from neuralrecon_w_tpu_torch.training import loop
    from neuralrecon_w_tpu_torch.training.schedule import scaled_lr

    torch.set_num_threads(2)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="trainer_vs_jax_", dir=os.path.join(ROOT, "build"))
    info = cs.cli_workspace(root, "cpu", CAMS + 1, WH, POINTS, CAM_DIST, 8, SFM_VOXEL)
    sc = info["scene_config"]
    pts = read_points3d_binary(os.path.join(root, "dense", "sparse", "points3D.bin"))
    sfm_unit = ((np.stack([p.xyz for p in pts.values()]) - np.asarray(sc["origin"]))
                / float(sc["radius"])).astype(np.float32)
    cfg_path = cs.write_cfg(os.path.join(root, "train.yaml"), root, {
        "NEUCONW": {**NARROW, "UPDATE_FREQ": args.update, "TRAIN_VOXEL_SIZE": TRAIN_VOXEL},
        "TPU": {"FIELD_DTYPE": "float32"},
        "TRAINER": {"VAL_FREQ": float(args.val), "SAVE_FREQ": 0}})

    jcfg = get_cfg_defaults()
    jcfg.merge_from_file(cfg_path)
    jcfg.TRAINER.LR = jax_scaled_lr(jcfg, BATCH)
    pcfg = load_cfg(cfg_path)
    pcfg.TRAINER.LR = scaled_lr(pcfg, BATCH)

    def tcfg(module, name):
        return module.TrainerConfig(batch_size=BATCH, num_epochs=1000, test_batch_size=256,
                                    exp_name=name, save_dir=os.path.join(root, "results"))

    # the JAX Trainer records no refresh statistics: wrap its octree_update
    jax_refreshes = []
    jax_octree_update = jax_loop.octree_update

    def recorded(params, *a, **kw):
        stats = {}
        host, dev = jax_octree_update(params, *a, stats_out=stats, **kw)
        fc = a[0]
        sdf = jax_sweep(params, fc, sfm_unit, None, 4096)
        jax_refreshes.append({**stats, "cells": set(map(tuple, np.asarray(host.coords).tolist()))
                              if host is not None else set(),
                              "sfm_sdf_median": float(np.median(sdf))})
        return host, dev

    jax_loop.octree_update = recorded
    jtr = jax_loop.Trainer(jcfg, tcfg(jax_loop, "jax"), make_mesh(1))
    init = jax.device_get(jtr.state)
    jtr.fit(max_steps=args.steps)

    ptr = loop.Trainer(pcfg, tcfg(loop, "port"), device="cpu")
    ptr.tcfg.log_every = 50  # the JAX Trainer logs every 50 steps and at the end
    ptr.state, _ = state_from_jax(init, ptr.fc, ptr.opt_spec, device="cpu")
    port_cells = []
    plain_refine = loop.Trainer.refine_surface

    def refine_and_probe(self):
        plain_refine(self)
        sdf = sharded_sdf_sweep(self.state.model, self.fc, sfm_unit, device=self.device)
        self.refreshes[-1]["sfm_sdf_median"] = float(np.median(sdf))
        port_cells.append(set(map(tuple, self.fine_grid_host.coords.tolist()))
                          if self.fine_grid_host is not None else set())

    loop.Trainer.refine_surface = refine_and_probe
    ptr.fit(max_steps=args.steps)

    out = {"refreshes": [], "losses": []}
    for j, p, pc in zip(jax_refreshes, ptr.refreshes, port_cells):
        diff = len(j["cells"] ^ pc)
        rec = {"step": p["step"], "candidates": p["n_candidates"],
               "kept_jax": j["kept_frac"], "kept_port": p["kept_frac"], "cells_differ": diff,
               "sfm_sdf_median_jax": j["sfm_sdf_median"],
               "sfm_sdf_median_port": p["sfm_sdf_median"]}
        out["refreshes"].append(rec)
        print(f"refresh at step {rec['step']}: {rec['candidates']} candidates; kept JAX "
              f"{rec['kept_jax']:.4f}, port {rec['kept_port']:.4f}; {diff} cells differ; median "
              f"sdf at the SFM points JAX {rec['sfm_sdf_median_jax']:.5f}, port "
              f"{rec['sfm_sdf_median_port']:.5f}", flush=True)

    def read(path):
        recs = {}
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                recs.setdefault(r.pop("step"), {}).update(r)
        return recs

    jl = read(os.path.join(root, "results", "jax", "logs", "metrics.jsonl"))
    pl = read(os.path.join(root, "results", "port", "logs", "metrics.jsonl"))
    for step in sorted(set(jl) & set(pl)):
        keys = [k for k in ("loss", "psnr", "s_val", "val/psnr", "val/fscore")
                if k in jl[step] and k in pl[step]]
        rec = {"step": step, **{f"{k} {who}": log[step][k] for k in keys
                                for who, log in (("jax", jl), ("port", pl))}}
        out["losses"].append(rec)
        print(f"step {step}: " + "; ".join(f"{k} JAX {rec[k + ' jax']:.6f}, port "
                                           f"{rec[k + ' port']:.6f}" for k in keys), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
