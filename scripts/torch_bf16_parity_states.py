#!/usr/bin/env python3
"""chip_smoke's ``step_parity`` at the CPU rehearsal's size (SDF 4x64,
colour 2x32, batch 48, 2 ring cameras of 12x8), on the states that the
rehearsal's training phases reach plus ``n`` more 'vjp' steps, for each
``n`` given: prints each state's step and the parity's failures, [] where
every mode holds its bound. On the CPU, with the kernels' plain versions.

    python3 scripts/torch_bf16_parity_states.py --extra 0,3,6,9
    python3 scripts/torch_bf16_parity_states.py --modes pallas,vjp,pallas_field --extra 6

``--modes`` sets the training turns (chip_smoke.TRAIN_MODES); the bf16
rule holds each kernel mode within max(2 x 'vjp''s error, 0.1) of the
f32 'vjp' gradient.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--extra", type=str, default="0,6",
                        help="'vjp' steps after the training phases, comma list")
    parser.add_argument("--modes", type=str, default="",
                        help="the training turns (default: chip_smoke.TRAIN_MODES)")
    args = parser.parse_args(argv)

    import torch

    import chip_smoke as cs
    from neuralrecon_w_tpu_torch.config import load_cfg
    from neuralrecon_w_tpu_torch.datasets.cache import RayPool
    from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
    from neuralrecon_w_tpu_torch.training.schedule import make_optimizer
    from neuralrecon_w_tpu_torch.training.step import init_state

    torch.set_num_threads(1)
    if args.modes:
        cs.TRAIN_MODES = tuple(args.modes.split(","))
    cs.TRAIN_BATCH = 48
    cfg = load_cfg(cs.CONFIG)
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
    n.SDF_CONFIG.skip_in = (2,)
    n.COLOR_CONFIG.d_feature, n.COLOR_CONFIG.d_hidden, n.COLOR_CONFIG.n_layers = 64, 32, 2
    n.N_VOCAB = 4
    scene, _, fine_host, _ = cs.make_scene("cpu", fine_level=5, sfm_voxel=0.2, wh=(4, 3),
                                           n_points=2000)
    fine = device_grid_from_host(fine_host, "cpu")
    for extra in (int(x) for x in args.extra.split(",")):
        rows, rgbs = cs.training_rays(n_cams=2, wh=(12, 8))
        pool = RayPool(rows, rgbs, seed=int(cfg.TRAINER.SEED))
        spec, _ = make_optimizer(cfg, cs.TRAIN_BATCH)
        state = init_state(cs.train_config(cfg, "pallas"), spec,
                           torch.Generator().manual_seed(0), "cpu")
        cs.training_phase(cfg, state, scene, pool, None, -1, "warm-up", n_timed=2)
        cs.training_phase(cfg, state, scene, pool, fine, fine_host.level, "steady", n_timed=2)
        step = cs.make_steps(cfg, cs.train_config(cfg, "vjp"), fine_host.level)
        for _ in range(extra):
            step(state, scene, pool.next_batch(cs.TRAIN_BATCH), fine)
        fails = cs.step_parity(cfg, state.model, scene, pool.next_batch(cs.TRAIN_BATCH), fine,
                               fine_host.level, "steady")
        print(f"STATE step {state.step} (+{extra} 'vjp'): {fails}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
