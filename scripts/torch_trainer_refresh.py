#!/usr/bin/env python3
"""The port's training CLI at the full width of
``config/train_brandenburg_gate_tpu.yaml`` on chip_smoke's trainer
workspace, in several variants of the loss weights, the learning rate
and the field dtype, to see where the surface refresh's kept share goes.

    python3 scripts/torch_trainer_refresh.py [--runs brandenburg:100:20,anchored:300:50]

Each run, ``variant:steps:update``, runs ``tools/train_cli.main`` for that
many steps at batch 8192 in the default 'vjp' mode, a refresh every
``update`` steps, a validation every 50, the scalars logged every 10. At every refresh it also reads the
SDF at the workspace's SFM points (which lie on the true surface): its
median there is the zero set's level shift, negative where the field
reads the surface as inside. Prints one line per refresh and per
variant, the card's name and power limit, and writes every record to
``chiprun_out/trainer_refresh.json``. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ANCHORED = {"LOSS": {"depth_weight": 1.0, "igr_weight": 1e-3}}
VARIANTS = {
    # the operating point as chip_smoke's trainer phase ran it before
    "brandenburg": {},
    "brandenburg_f32": {"TPU": {"FIELD_DTYPE": "float32"}},
    "brandenburg_lr": {"TRAINER": {"CANONICAL_LR": 5e-4}},
    "brandenburg_half_lr": {"TRAINER": {"LR": 1e-4}},
    # scripts/exp_synth_convergence.py's anchoring on the synthetic sphere
    "anchored": {"NEUCONW": ANCHORED},
    "anchored_lr": {"NEUCONW": ANCHORED, "TRAINER": {"CANONICAL_LR": 5e-4}},
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=str,
                        default=",".join(f"{v}:100:20" for v in VARIANTS))
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_trainer_refresh: needs a CUDA card", file=sys.stderr)
        return 2
    from neuralrecon_w_tpu_torch.datasets.colmap import read_points3d_binary
    from neuralrecon_w_tpu_torch.ops import build, native
    from neuralrecon_w_tpu_torch.parallel.sweep import sharded_sdf_sweep
    from neuralrecon_w_tpu_torch.training import loop

    card = cs.card_line()
    build.kernels()
    native.build()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="trainer_refresh_", dir=os.path.join(ROOT, "build"))
    info = cs.cli_workspace(root, "cuda", cs.TRAINER_CAMS + 1, cs.IMG_WH, cs.TRAINER_POINTS,
                            cs.TRAINER_CAM_DIST, 64, cs.SFM_VOXEL)
    sc = info["scene_config"]
    pts = read_points3d_binary(os.path.join(root, "dense", "sparse", "points3D.bin"))
    xyz = np.stack([p.xyz for p in pts.values()])
    sfm_unit = ((xyz - np.asarray(sc["origin"])) / float(sc["radius"])).astype(np.float32)

    plain_refine = loop.Trainer.refine_surface

    def refine_and_probe(self):
        plain_refine(self)
        sdf = sharded_sdf_sweep(self.state.model, self.fc, sfm_unit, device=self.device)
        self.refreshes[-1].update(sfm_sdf_median=float(np.median(sdf)),
                                  sfm_sdf_p10=float(np.percentile(sdf, 10)),
                                  sfm_sdf_p90=float(np.percentile(sdf, 90)))

    loop.Trainer.refine_surface = refine_and_probe
    out = {"card": card, "batch": cs.TRAIN_BATCH, "runs": {}}
    for run in args.runs.split(","):
        variant, steps, update = run.split(":")
        name = f"{variant}_{steps}_{update}"
        overrides = cs.merged({"NEUCONW": {"UPDATE_FREQ": int(update),
                                           "TRAIN_VOXEL_SIZE": cs.TRAINER_VOXEL},
                               "TRAINER": {"VAL_FREQ": 50.0, "SAVE_FREQ": 0}},
                              VARIANTS[variant])
        cfg_path = cs.write_cfg(os.path.join(root, f"{name}.yaml"), root, overrides)
        t0 = time.perf_counter()
        tr = cs.train_cli(cfg_path, os.path.join(root, "results"), name, cs.TRAIN_BATCH,
                          int(steps), "cuda", ["--log_every", "10", "--test_batch_size",
                                               str(cs.TRAIN_BATCH)])
        cs.sync()
        recs = cs.log_records(tr.logger.path)
        res = {"overrides": VARIANTS[variant], "steps": int(steps), "update": int(update), "lr": tr.cfg.TRAINER.LR,
               "wall_s": time.perf_counter() - t0, "refreshes": tr.refreshes,
               "log": [r for r in recs if "loss" in r],
               "val": [r for r in recs if "val/psnr" in r]}
        out["runs"][name] = res
        for r in tr.refreshes:
            print(f"{name} refresh at step {r['step']}: kept {r['n_kept']} of "
                  f"{r['n_candidates']} ({r['kept_frac']:.4f}); sdf at the SFM points "
                  f"median {r['sfm_sdf_median']:.5f} (p10 {r['sfm_sdf_p10']:.5f}, p90 "
                  f"{r['sfm_sdf_p90']:.5f})", flush=True)
        print(f"{name} ({card}): lr {res['lr']:.3g}; loss " + ", ".join(
            f"{r['step']} {r['loss']:.4f}" for r in res["log"]) + "; psnr " + ", ".join(
            f"{r['step']} {r['psnr']:.2f}" for r in res["log"]) + "; val " + ", ".join(
            f"{r['step']} psnr {r['val/psnr']:.3f} F@0.1 {r.get('val/fscore', float('nan')):.4f}"
            for r in res["val"]) + f"; wall {res['wall_s']:.1f} s", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "trainer_refresh.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
