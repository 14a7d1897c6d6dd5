#!/usr/bin/env python3
"""Chip smoke of Neuralangelo's hash-grid SDF field
(``neuralrecon_w_tpu_torch/configs/train_neuralangelo_op.yaml``) through the
port's CLIs, at every published width:

    python3 chip_smoke_neuralangelo.py [--steps 300] [--device cuda]

(``--device cpu --tiny --steps 40 --update 20 --level_every 10 --batch 512``
rehearses it on the CPU at a small grid.)

On chip_smoke's synthetic workspace (``chip_smoke.cli_workspace``: 12 + 1
views, 40,000 SFM points, the training level 10) it runs
``tools/train_cli`` for ``--steps`` steps on the device pool (the captured
dispatch on a card) with a surface refresh every ``--update`` steps and one
more level every ``--level_every`` steps from 4, so the run crosses at
least one refresh and one level increase; then ``tools/render_cli`` renders
the held-out view from the last checkpoint (the captured chunk). It checks
that the logged losses are finite and fall, that each refresh kept cells,
that the active levels followed the schedule and that the frame is finite,
and prints the hash kernels' launches (K13 ``hash_encode``, K14
``hash_grad``, a graph's replays included) and the points K13 encoded a
step. Exits 1 on a failed check. ``chip_smoke.py`` runs it too
(``smoke``), and takes K13's and K14's launches from it."""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time
from unittest import mock

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
YAML = os.path.join(ROOT, "neuralrecon_w_tpu_torch", "configs", "train_neuralangelo_op.yaml")
HASH_KERNELS = ("hash_encode", "hash_grad", "hash_points")


# --tiny: a small grid and MLP for a rehearsal on the CPU (tests/test_torch_neuralangelo.py)
TINY_SDF = {"levels": 6, "log2_table": 12, "min_res": 4, "max_res": 64, "d_hidden": 32,
            "d_out": 33}


def write_cfg(path: str, root: str, update: int, level_every: int, steps: int,
              tiny: bool = False) -> str:
    import yaml

    sdf = {"type": "hashgrid", "level_every": level_every, **(TINY_SDF if tiny else {})}
    neuconw = {"UPDATE_FREQ": update, "TRAIN_VOXEL_SIZE": cs.TRAINER_VOXEL, "SDF_CONFIG": sdf}
    if tiny:
        # and a level-8 refresh, 64x fewer candidates to sweep than level 10's
        neuconw.update(COLOR_CONFIG={"d_feature": 32}, TRAIN_VOXEL_SIZE=4 * cs.TRAINER_VOXEL)
    with open(path, "w") as f:
        yaml.safe_dump({"_BASE_": YAML, "DATASET": {"ROOT_DIR": root}, "NEUCONW": neuconw,
                        "TRAINER": {"VAL_FREQ": float(10 * steps), "SAVE_FREQ": steps}}, f)
    return path


def graph_launches(counted: dict, runs) -> dict:
    """The launches the training ran: each captured step's counted once at
    capture, so every run adds (replays - captures) x its step's launches."""
    out = dict(counted)
    for run in runs:
        for k, v in run.per_step_launches.items():
            out[k] = out.get(k, 0) + (run.replays - run.captures) * v
    return out


def smoke(root: str, device: str = "cuda", steps: int = 300, update: int = 150,
          level_every: int = 100, batch: int = 4096, tiny: bool = False) -> tuple:
    """The smoke in the workspace ``root``: (the launches by run,
    "train_cli" and "render_cli", each keyed as ``read_counts``; the failed
    checks)."""
    import numpy as np
    import torch
    from PIL import Image

    from neuralrecon_w_tpu_torch.tools import render_cli
    from neuralrecon_w_tpu_torch.training import step as step_mod
    from neuralrecon_w_tpu_torch.training.checkpoint import latest_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        print(cs.card_line())
    fails = []
    t0 = time.perf_counter()
    info = cs.cli_workspace(root, device, cs.TRAINER_CAMS + 1, cs.IMG_WH,
                            cs.TRAINER_POINTS, cs.TRAINER_CAM_DIST, 64, cs.SFM_VOXEL)
    cfg_path = write_cfg(os.path.join(root, "train.yaml"), root, update, level_every,
                         steps, tiny)
    print(f"workspace: {info['n_points']} SFM points, cache {info['cache_seconds']:.1f} s")
    cs.reset_counts()
    t1 = time.perf_counter()
    tr = cs.train_cli(cfg_path, os.path.join(root, "results"), "neuralangelo", batch,
                      steps, device, ["--log_every", str(max(1, steps // 12))])
    cs.sync()
    wall = time.perf_counter() - t1
    launches = graph_launches(cs.read_counts(), tr.scan_runs())
    net = tr.state.model.neuconw.sdf_net
    want_levels = net.levels_at(steps - 1)
    print(f"train_cli: {tr.state.step} steps at batch {batch} in {wall:.1f} s; active "
          f"levels {int(net.active)} (schedule {want_levels}), e = {float(net.tap_distance()):.3e}")
    if tr.state.step != steps:
        fails.append(f"train_cli ended at step {tr.state.step}")
    if int(net.active) != want_levels or want_levels <= net.init_active:
        fails.append(f"active levels {int(net.active)}, the schedule's {want_levels}")
    for r in tr.refreshes:
        print(f"refresh at step {r['step']}: {r['seconds']:.2f} s (sweep "
              f"{r.get('sweep_seconds', float('nan')):.2f} s), {r.get('n_kept')} of "
              f"{r.get('n_candidates')} kept")
        # a keep of ~100 % (the zero set outside the SFM shell) is the
        # synthetic scene's, as chip_smoke's trainer shows for the MLP field
        if not 0 < r.get("n_kept", 0):
            fails.append(f"refresh at step {r['step']} kept no cell")
    if not tr.refreshes:
        fails.append("no surface refresh ran")
    recs = cs.log_records(tr.logger.path)
    for r in recs:
        print(f"  step {r['step']}: loss {r['loss']:.4f} curvature "
              f"{r.get('curvature_loss', float('nan')):.3e} eikonal {r['normal_loss']:.4f} "
              f"psnr {r['psnr']:.2f} rays/s {r['rays_per_sec']:.0f}")
    if any(not math.isfinite(v) for r in recs for v in r.values()):
        fails.append("a logged scalar is not finite")
    if not recs or "curvature_loss" not in recs[0] or recs[-1]["loss"] >= recs[0]["loss"]:
        fails.append("the logged loss did not fall (or has no curvature term)")
    per_step = {k: v for run in tr.scan_runs() for k, v in run.per_step_launches.items()
                if k in HASH_KERNELS}
    print("training launches: " + ", ".join(f"{k} {launches.get(k, 0)}" for k in HASH_KERNELS)
          + f"; a captured step: {per_step}")
    if device == "cuda" and not all(launches.get(k, 0) > 0 for k in HASH_KERNELS):
        fails.append("a hash kernel did not run in training")

    ck = latest_checkpoint(os.path.join(root, "results", "neuralangelo", "checkpoints"))
    made, real = [], step_mod.make_scan_render_fn

    def recording(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    out = os.path.join(root, "render")
    cs.reset_counts()
    t1 = time.perf_counter()
    with mock.patch.object(step_mod, "make_scan_render_fn", recording):
        render_cli.main(["--cfg_path", cfg_path, "--ckpt_path", ck, "--out_dir", out,
                         "--img_downscale", "1", "--chunk", "512", "--dispatch", "scan",
                         "--device", device])
    cs.sync()
    got = cs.read_counts()
    if made and device == "cuda":
        got = cs.scan_launches(got, made[-1])
    pngs = sorted(os.listdir(out))
    img = [np.asarray(Image.open(os.path.join(out, n))) for n in pngs]
    print(f"render_cli: {pngs} in {time.perf_counter() - t1:.1f} s; launches "
          + ", ".join(f"{k} {got.get(k, 0)}" for k in HASH_KERNELS)
          + (f"; a captured chunk {made[-1].per_chunk_launches}" if made else ""))
    if not pngs or any(a.size == 0 for a in img):
        fails.append("render_cli wrote no image")
    if device == "cuda" and not got.get("hash_encode", 0) > 0:
        fails.append("K13 did not run in render_cli")
    print(f"smoke wall {time.perf_counter() - t0:.1f} s")
    return {"train_cli": launches, "render_cli": got}, fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--update", type=int, default=150)
    ap.add_argument("--level_every", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None, help="the workspace (default: a temporary one)")
    ap.add_argument("--tiny", action="store_true", help="a small grid and MLP (a CPU rehearsal)")
    args = ap.parse_args(argv)
    _, fails = smoke(args.root or tempfile.mkdtemp(prefix="neuralangelo_smoke_"), args.device,
                     args.steps, args.update, args.level_every, args.batch, args.tiny)
    print("PASS" if not fails else "FAIL: " + "; ".join(fails))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
