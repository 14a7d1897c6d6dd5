#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port: its serving path and its
training step.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's Hopper kernels from ``neuralrecon_w_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version at the serving
shapes, then serves novel views through ``make_render_fn`` and
``render_image`` at the full width of ``config/train_brandenburg_gate_tpu.yaml``
(random geometric-init weights from a seeded ``torch.Generator``) in both
serving phases: warm-up (SFM-grid near/far only) and steady (a flat
level-10 fine grid with boundary samples). The scene is made in-process
with numpy: SFM points on a sphere of radius 1, the SFM grid from
``grid_from_points``, the fine grid a shell around that sphere, cameras
on a ring. It checks the outputs, counts the kernel launches of the
serving run, and prints timings with the card's name and power limit.
The kernels are held to their plain versions on a copy of the SDF net
with seeded noise on every weight and bias (``live_sdf_net``): the
geometric init zeroes the sin / cos columns, the skip's PE half and the
hidden biases, which would leave those parts of K1 unchecked.

    python3 chip_smoke.py --profile

adds, for one chunk of each serving phase, the wall time of the plain and
the kernel path in turns and a torch.profiler breakdown by renderer span,
and for one training step per phase and grad mode a breakdown by the
step's spans (``train.render_loss``, ``train.optimizer``) and the
renderer's.

Then it holds the SDF-VJP kernels (K3 forward, K4 backward, K5 the dW
reduction; ``csrc/sdf_vjp.cu``) against their plain version on the live
net, the backward also against float64, and times them at the steady
phase's 245,760 points beside the plain version and the torch double
backward. Then it trains: ``init_state`` and ``make_train_step`` over the
port's ``RayPool`` at batch 8192, on ring-camera rays of the analytic
sphere (numpy shading, sky and person labels, SFM depth on a quarter of
the hits, near / far from the bounding sphere), warm-up and then steady
on the level-10 fine grid, with ``SDF_GRAD_MODE`` 'pallas' (the kernels)
and 'vjp' (the double backward) in turns; it counts the kernel launches
of each phase, checks the losses are finite and the parameters move, and
holds one step of 'pallas' against 'vjp' from one state and one batch.

Then it extracts a mesh: K6 (``csrc/field_fwd.cu``, the fused field
forward) against its plain version on the live field, f32 and bf16, and
K1 in f32 at the SDF sweep's chunk; a phototourism-style workspace under
``build/`` whose 500,000 SFM points sit on the served field's own zero
set (a sign change found along seeded directions and bisected, with K1 in
f32), that field saved with ``save_checkpoint``, and ``tools/extract_mesh_cli.main`` with
the flags of ``scripts/sdf_extract.sh`` at ``--eval_level 10``. It checks
the ply (non-empty, finite, normals unit, vertices on the field's zero
set), counts the K1 and K6 launches of the extraction, prints each
stage's seconds, and holds the path's SDF sweep (every grid point) and
vertex colours against the plain versions.

The last lines are the card line, a JSON object with one entry per
kernel (K1 and K2 with their serving launches, K3 to K5 with their
training launches, K6 with its extraction launches; each with its time,
its plain version's, and the least time the card could take for the
same work, ``bound_ms``), and ``{"ok": true, "device": {...}}``. It exits
non-zero, with no result line, when there is no CUDA device or any check
fails.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "config", "train_brandenburg_gate_tpu.yaml")
SEED = 0
CHUNK = 8192
IMG_WH = (160, 120)
FRAMES = 3  # per phase; the first is untimed
SFM_VOXEL = 0.0117  # -> SFM grid level 8 over the +-1.5 bbx
FINE_LEVEL = 10
SHELL_HALF_CELLS = 2.0  # fine-grid shell half thickness, in fine cells
LIVE_EPS = 0.02  # noise of live_sdf_net, in units of the init's scale

# kernel-versus-plain bounds
K1_F32_ATOL, K1_F32_RTOL = 1e-4, 1e-4  # summation order only
K1_BF16_ATOL = 2e-2  # bf16 rounds a flipped ulp differently along 8 layers
# K2 alone on identical inputs: a draw can flip at a CDF tie
SAMPLER_Z_ATOL, SAMPLER_RAY_FRAC = 1e-4, 0.999
# the whole stage: K1's f32 rounding (~4e-7) enters K2's cosine through
# near-duplicate samples ((s1 - s0) / (z1 - z0 + 1e-5)), and the min with
# the next section's cosine carries it on; a few rays in a thousand draw
# elsewhere in the same bin
STAGE_RAY_FRAC = 0.995
# kernel path vs plain path, one f32 chunk: a sample flipped at a CDF tie
# moves a ray's color / depth a little; almost every ray must agree
PATH_ATOL, PATH_RAY_FRAC = 1e-3, 0.999
# in bf16 an activation that K1 and its plain version sum in another order
# can round to the neighbouring bf16 value, and the sampler turns that ulp
# of sdf into a moved sample on some rays: bound the mean difference per ray
PATH_BF16_MEAN = 5e-3

# training (PERF.md holds the bounds and why)
TRAIN_BATCH = 8192
TRAIN_CAMS = 12
TRAIN_TIMED = 6  # timed steps per grad mode and phase
LABEL_SKY, LABEL_BUILDING, LABEL_PERSON = 2, 1, 12
VJP_CHECK_PTS = 8192  # K3 / K4 + K5 against the plain version (and f64)
VJP_TIME_PTS = 8192 * 30  # the steady phase's samples per step
K3_F32_TOL = 1e-4
VJP_BF16_REL = 5e-2  # kernels vs the plain version in bf16, rel-L2 per output
# pallas vs vjp, one step from one state. In f32: (loss rtol, rel-L2 per
# parameter gradient) between the two modes. In bf16 the two modes round
# the SDF forward at other places (the 'vjp' matmuls round their outputs
# and add the bias in bf16, K3 keeps both in f32), which moves every loss by
# ~1 %; and a gradient is a sum over ~200k points whose rounding errors do
# not cancel as its signal does, so each mode's bf16 gradient lies a few
# percent to O(1) off the f32 one, independently. So in bf16 both are held
# to the f32 'vjp' gradient of the same step: 'pallas' may be off it by at
# most PARITY_BF16_RATIO times what 'vjp' is, or by PARITY_BF16_FLOOR (the
# bf16 weights shift the SDF's mean a little differently in each mode, which
# moves a sum over the surface such as the last layer's sdf bias by percents).
PARITY_F32 = (1e-4, 1e-2)
PARITY_BF16_LOSS, PARITY_BF16_RATIO, PARITY_BF16_FLOOR = 3e-2, 2.0, 1e-1

# extraction (PERF.md holds the bounds and why)
EXTRACT_POINTS = 500_000  # SFM points on the field's zero set
EXTRACT_LEVEL = 10
EXTRACT_CHUNK = 102144  # scripts/sdf_extract.sh
COLOR_CHUNK = 65536  # extraction/mesh.py's chunk_rgb
MIN_TRACK = 2  # the workspace's min_track_length; every point has a longer track
# Where the field's zero set lies is the field's own business: the seed-0
# geometric init crosses at |x| 0.24-0.38 in unit coordinates, and training
# moves it. So each seeded direction is scanned for a sign change and the
# crossing bisected; the workspace's scene radius then puts the farthest
# crossing EXTRACT_REACH SFM units from the origin, inside the +-1.5 eval
# bbx (at the init, the surface ~1.1 SFM units out: ~110k level-8 cells).
EXTRACT_REACH = 1.4
ZERO_SCAN = (0.02, 0.98, 16)  # radii scanned per direction, unit coordinates
ZERO_DIRS = 1.25  # directions drawn per SFM point wanted; some may not cross
BISECT_TOL = 1e-6
SDF_PROBE_CELLS = 0.05  # median |sdf| at the mesh's vertices, in level-10 cells
NORMAL_SHORT_FRAC = 1e-4  # normals short of unit (sliver faces only), share of vertices
COLOR_LEVELS, COLOR_FRAC = 2, 0.999  # vertex colours, kernel path vs plain
K6_CHECK_PTS = COLOR_CHUNK

# the H100 SXM's published peaks (NVIDIA's datasheet): dense bf16
# tensor cores, float32 outside them, HBM3
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def bound(flops: float, n_bytes: float, act: str) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak of their type and the bytes over the memory rate."""
    t_ops = flops / (PEAK_BF16 if act == "bfloat16" else PEAK_F32)
    t_mem = n_bytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_mem) * 1e3,
            "bound_by": "operations" if t_ops >= t_mem else "bytes"}


def gemm_flops(dims) -> int:
    """2 k n per point over the (k, n) of each product."""
    return 2 * sum(k * n for k, n in dims)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sync() -> None:
    """Waits for the card, where there is one (the CPU rehearsal has none)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of fn() on the card, after one warm-up call."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ------------------------------- the scene -------------------------------


def shell_coords(level: int, scale: float, radius: float, half_cells: float):
    """Cells of a level-``level`` grid over [-scale, scale]^3 whose
    centres lie within half_cells cells of the sphere |x| = radius, built
    column by column (no dense 2^{3L} pass)."""
    import numpy as np

    n = 1 << level
    cw = 2.0 * scale / n
    c = (np.arange(n) + 0.5) * cw - scale
    rho2 = c[:, None] ** 2 + c[None, :] ** 2
    r_in2, r_out2 = (radius - half_cells * cw) ** 2, (radius + half_cells * cw) ** 2
    zmax = np.sqrt(np.clip(r_out2 - rho2, 0.0, None))
    zmin = np.sqrt(np.clip(r_in2 - rho2, 0.0, None))
    ok = rho2 <= r_out2

    def k_range(lo, hi):  # cell indices with centre in [lo, hi]
        return (np.ceil((lo + scale) / cw - 0.5).astype(np.int64),
                np.floor((hi + scale) / cw - 0.5).astype(np.int64))

    one = ok & (zmin == 0.0)  # the column crosses the shell once
    ranges = [k_range(-zmax, zmax) + (one,),
              k_range(zmin, zmax) + (ok & ~one,), k_range(-zmax, -zmin) + (ok & ~one,)]
    coords = []
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    for lo, hi, mask in ranges:
        lo, hi = np.clip(lo, 0, n - 1)[mask], np.clip(hi, 0, n - 1)[mask]
        cnt = np.maximum(hi - lo + 1, 0)
        start = np.repeat(lo, cnt)
        off = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        coords.append(np.stack([np.repeat(ii[mask], cnt), np.repeat(jj[mask], cnt),
                                start + off], axis=1))
    return np.concatenate(coords).astype(np.int32)


def sphere_points(n: int, radius: float = 1.0):
    """n points on the sphere |x| = radius: the scene's SFM keypoints."""
    import numpy as np

    v = np.random.default_rng(SEED).standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True) * radius


def camera_rays(wh, focal: float, eye):
    """(H*W, 3) origins and unit directions of a pinhole camera at eye
    looking at the origin, z up (OpenGL camera: x right, y up, looking
    down -z; no half-pixel offset, as ``datasets/rays.py`` has it)."""
    import numpy as np

    w, h = wh
    j, i = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                       indexing="ij")
    dirs = np.stack([(i - w / 2) / focal, -(j - h / 2) / focal, -np.ones_like(i)], -1)
    back = eye / np.linalg.norm(eye)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    d = dirs.reshape(-1, 3) @ np.stack([right, up, back], axis=1).T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.broadcast_to(eye, d.shape), d


def make_scene(device, fine_level: int = FINE_LEVEL, sfm_voxel: float = SFM_VOXEL,
               wh=IMG_WH, n_points: int = 50000):
    """SceneInfo, SFM VoxelGrid and fine VoxelGrid of a unit sphere, and
    a camera ring's rays. SFM units; the training sphere has radius 2."""
    import numpy as np

    from neuralrecon_w_tpu_torch.ops.voxel_grid import VoxelGrid, grid_from_points
    from neuralrecon_w_tpu_torch.utils.scene import scene_info

    rng = np.random.default_rng(SEED)
    pts = sphere_points(n_points)
    bbx = np.full(3, 1.5)
    sfm_grid = grid_from_points(pts, -bbx, bbx, sfm_voxel, expand=1, radius=1.0)
    fine = VoxelGrid(fine_level, sfm_grid.origin, sfm_grid.scale,
                     shell_coords(fine_level, sfm_grid.scale, 1.0, SHELL_HALF_CELLS))
    scene = scene_info({"origin": [0.0, 0.0, 0.0], "radius": 2.0}, device)

    frames = []
    for f in range(FRAMES):
        ang = 2 * np.pi * f / FRAMES + rng.uniform(0, 0.1)
        eye = np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 0.6])
        o, d = camera_rays(wh, 1.2 * wh[0], eye)
        n = len(o)
        rays = np.concatenate([o, d, np.full((n, 1), 0.5), np.full((n, 1), 6.0),
                               np.zeros((n, 2))], axis=1).astype(np.float32)
        frames.append(rays)
    return scene, sfm_grid, fine, frames


# ------------------------------- phases -------------------------------


def live_sdf_net(net, seed: int = SEED, eps: float = LIVE_EPS):
    """A copy of the SDF net in which every input reaches the output.
    The geometric init zeroes layer 0's sin / cos columns, the PE half of
    the skip input and every hidden bias, and makes the last layer nearly
    constant; seeded noise on every weight (eps times the init's scale)
    and bias (eps) makes a kernel that drops or permutes any of them
    disagree with its plain version."""
    import torch

    live = copy.deepcopy(net)
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for l in range(live.n_layers):
            layer = live.layer(l)
            d_out, d_in = layer.weight_v.shape
            sd = eps / math.sqrt(d_in) if l == live.n_layers - 1 else eps * math.sqrt(2.0 / d_out)
            layer.weight_v.add_(sd * torch.randn(d_out, d_in, generator=g).to(layer.weight_v))
            layer.bias.add_(eps * torch.randn(d_out, generator=g).to(layer.bias))
    return live


def live_field(model, seed: int = SEED):
    """A copy of the field with ``live_sdf_net``'s SDF net. Its colour net
    keeps the seeded torch-default init, U(+-1/sqrt(d_in)) on every weight
    and bias, which already reaches every input."""
    live = copy.deepcopy(model)
    live.neuconw.sdf_net = live_sdf_net(model.neuconw.sdf_net, seed)
    return live


def kernel_phase(model, fc, rays_o, rays_d, z_base, n_pts_cmp: int):
    """Each kernel against its plain version at the serving shapes, on the
    live copy of the served SDF net."""
    import torch

    from neuralrecon_w_tpu_torch.ops import importance_sampler as smp
    from neuralrecon_w_tpu_torch.ops import sdf_mlp

    dev = rays_o.device
    net = live_sdf_net(model.neuconw.sdf_net)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    pts = ((torch.rand(n_pts_cmp, 3, generator=g) * 2 - 1) * 0.9).to(dev)
    res, fails = {}, []

    for act in ("float32", "bfloat16"):
        packed = sdf_mlp.pack_sdf_weights(net, fc.sdf, act)
        got = sdf_mlp.fused_sdf_head(packed, pts)
        want = sdf_mlp.sdf_mlp_plain(packed, pts)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and (
            bool((err <= K1_F32_ATOL + K1_F32_RTOL * want.abs()).all()) if act == "float32"
            else float(err.max()) <= K1_BF16_ATOL)
        print(f"K1 sdf_mlp {act} on {n_pts_cmp} pts: max|err| {float(err.max()):.3e} "
              f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"K1 {act}")

    # timings at the serving shape: the act dtype of the config, 8 samples a ray
    packed = sdf_mlp.pack_sdf_weights(net, fc.sdf, fc.act_dtype)
    pts_srv = (rays_o[:, None, :] + rays_d[:, None, :] * z_base[..., None]).reshape(-1, 3)
    k1_err = float((sdf_mlp.fused_sdf_head(packed, pts_srv)
                    - sdf_mlp.sdf_mlp_plain(packed, pts_srv)).abs().max())
    k1_ms = cuda_ms(lambda: sdf_mlp.fused_sdf_head(packed, pts_srv))
    k1_plain = cuda_ms(lambda: sdf_mlp.sdf_mlp_plain(packed, pts_srv))
    k1_ms2 = cuda_ms(lambda: sdf_mlp.fused_sdf_head(packed, pts_srv))
    print(f"K1 sdf_mlp {fc.act_dtype} at {pts_srv.shape[0]} pts: kernel {k1_ms:.3f} / "
          f"{k1_ms2:.3f} ms, plain {k1_plain:.3f} ms, max|err| {k1_err:.3e}")
    n_srv = pts_srv.shape[0]
    res["sdf_mlp"] = {"max_abs_err": k1_err, "ms": min(k1_ms, k1_ms2), "plain_ms": k1_plain,
                      "library_ms": None,
                      **bound(n_srv * gemm_flops(zip(packed.k, packed.n)),
                              nbytes(pts_srv, packed.w, packed.b) + 4 * n_srv, fc.act_dtype)}

    # K2 alone, the last round at the serving shapes (8 + 8 samples, 8 draws)
    sdf0 = sdf_mlp.sdf_mlp_plain(packed, pts_srv).view(z_base.shape)
    z1, s1, new = smp.up_sample_round_plain(rays_o, rays_d, z_base, sdf0, None, None, 8, 512.0, False)
    s_new = sdf_mlp.sdf_mlp_plain(packed, (rays_o[:, None] + rays_d[:, None] * new[..., None])
                                  .reshape(-1, 3)).view(new.shape)
    args = (rays_o, rays_d, z1, s1, new, s_new, 8, 1024.0, True)
    got, want = smp.up_sample_round(*args), smp.up_sample_round_plain(*args)
    rows = ((got - want).abs() <= SAMPLER_Z_ATOL).all(dim=1).float().mean().item()
    k2_err = float((got - want).abs().max())
    k2_ms = cuda_ms(lambda: smp.up_sample_round(*args))
    k2_plain = cuda_ms(lambda: smp.up_sample_round_plain(*args))
    k2_ms2 = cuda_ms(lambda: smp.up_sample_round(*args))
    ok = rows >= SAMPLER_RAY_FRAC
    print(f"K2 up_sample last round on {rays_o.shape[0]} rays: rays within {SAMPLER_Z_ATOL} "
          f"{rows:.5f}, max|err| {k2_err:.3e}; kernel {k2_ms:.3f} / {k2_ms2:.3f} ms, "
          f"plain {k2_plain:.3f} ms -> {'ok' if ok else 'FAIL'}")
    if not ok:
        fails.append("K2")
    res["up_sample"] = {"max_abs_err": k2_err, "ms": min(k2_ms, k2_ms2), "plain_ms": k2_plain,
                        "library_ms": None,
                        **bound(0, nbytes(*(a for a in args if hasattr(a, "numel")), got),
                                "float32")}

    # the whole importance stage, f32 and the serving dtype
    for act in ("float32", fc.act_dtype) if fc.act_dtype != "float32" else ("float32",):
        run = lambda f: f(net, fc.sdf, rays_o, rays_d, z_base, 16, 2, 3, act)  # noqa: E731
        got, want = run(smp.fused_importance_sampler), run(smp.importance_sampler_plain)
        rows = ((got - want).abs() <= SAMPLER_Z_ATOL).all(dim=1).float().mean().item()
        sorted_ok = bool((torch.diff(got, dim=1) >= 0).all())
        t_k = cuda_ms(lambda: run(smp.fused_importance_sampler), reps=3)
        t_p = cuda_ms(lambda: run(smp.importance_sampler_plain), reps=3)
        ok = sorted_ok and (rows >= STAGE_RAY_FRAC or act != "float32")
        print(f"sampler {act} on {rays_o.shape[0]} rays: rays within {SAMPLER_Z_ATOL} "
              f"{rows:.5f} (max|err| {float((got - want).abs().max()):.3e}), sorted {sorted_ok}; "
              f"kernels {t_k:.3f} ms, plain {t_p:.3f} ms -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"sampler {act}")
    return res, fails


def serving_phase(model, fc, rcfg, scene, frames, fine_grid, sfm_grid, label):
    """Render FRAMES frames through make_render_fn + render_image; the
    first is untimed. Returns (rays/s, outputs of the last frame)."""
    import numpy as np
    import torch

    from neuralrecon_w_tpu_torch.training.step import make_render_fn
    from neuralrecon_w_tpu_torch.training.validation import render_image

    render_chunk = make_render_fn(fc, rcfg)
    w, h = IMG_WH
    seconds, outs = 0.0, []
    for f, rays in enumerate(frames):
        ts = np.full((len(rays),), f, np.int64)
        labels = np.zeros((len(rays),), np.int64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_image(render_chunk, model, scene, rays, ts, labels, (w, h), CHUNK,
                           fine_grid, sfm_grid)
        torch.cuda.synchronize()
        if f > 0:
            seconds += time.perf_counter() - t0
        outs.append(out)
    rps = (len(frames) - 1) * w * h / seconds
    print(f"serving {label}: {len(frames) - 1} timed frames of {w}x{h} at chunk {CHUNK}: "
          f"{rps:.1f} rays/s")
    return rps, outs


def check_frames(outs, frames, label, wh=IMG_WH):
    import numpy as np

    fails = []
    for out, rays in zip(outs, frames):
        for k, v in out.items():
            if v.shape[:2] != (wh[1], wh[0]) or not np.all(np.isfinite(v)):
                fails.append(f"{label} {k} not finite or misshapen")
    c = np.concatenate([o["color"].reshape(-1, 3) for o in outs])
    print(f"{label}: {len(outs)} frames finite, color range [{c.min():.3f}, {c.max():.3f}]")
    return fails


def path_check(model, fc, rcfg, scene, rays, fine_grid, sfm_grid, label):
    """One chunk through the kernel path and the plain path (the plain
    sampler, ``importance_sampler_plain``), in f32 and in the served
    activation dtype. The foreground color (``color_sphere``) must lie in
    [0, 1]; the composite color need not with random weights, because the
    background NeRF's rgb head is linear, as in the JAX package
    (models/nerf_bg.py:102)."""
    import torch

    from neuralrecon_w_tpu_torch.training.step import make_render_fn

    dev = scene.origin.device
    r = torch.as_tensor(rays[:CHUNK], device=dev)
    ts = torch.zeros(r.shape[0], dtype=torch.long, device=dev)
    fails = []
    for act in dict.fromkeys(("float32", fc.act_dtype)):
        fc_act = fc._replace(act_dtype=act)
        outs = [make_render_fn(fc_act, rcfg._replace(fused_sampler_sdf=fused))(
            model, scene, r, ts, ts, None, fine_grid, sfm_grid) for fused in (True, False)]
        cs = outs[0]["color_sphere"]
        if not bool(torch.isfinite(cs).all()) or cs.min() < 0.0 or cs.max() > 1.0:
            fails.append(f"{label} {act} foreground color outside [0, 1]")
        for k in ("color", "depth"):
            diff = (outs[0][k] - outs[1][k]).abs().reshape(r.shape[0], -1).amax(dim=1)
            frac = (diff <= PATH_ATOL).float().mean().item()
            print(f"{label} {act} chunk, kernel vs plain path: {k} max|diff| "
                  f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e}, rays within "
                  f"{PATH_ATOL} {frac:.5f}")
            if act == "float32" and frac < PATH_RAY_FRAC:
                fails.append(f"{label} kernel vs plain {k}")
            if act != "float32" and float(diff.mean()) > PATH_BF16_MEAN:
                fails.append(f"{label} {act} kernel vs plain {k}")
    return fails


def profile_chunk(model, fc, rcfg, scene, rays, fine_grid, sfm_grid, label) -> None:
    """torch.profiler over one warm chunk: device time by op and by the
    renderer's spans, and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neuralrecon_w_tpu_torch.training.step import make_render_fn

    dev = scene.origin.device
    r = torch.as_tensor(rays[:CHUNK], device=dev)
    ts = torch.zeros(r.shape[0], dtype=torch.long, device=dev)
    render_chunk = make_render_fn(fc, rcfg)
    render_chunk(model, scene, r, ts, ts, None, fine_grid, sfm_grid)
    torch.cuda.synchronize()
    # the chunk through the kernels and through the plain sampler, in turns
    walls = {"plain": [], "kernels": []}
    for path in ("plain", "kernels", "kernels", "plain"):
        fn = make_render_fn(fc, rcfg._replace(fused_sampler_sdf=path == "kernels"))
        t0 = time.perf_counter()
        fn(model, scene, r, ts, ts, None, fine_grid, sfm_grid)
        torch.cuda.synchronize()
        walls[path].append((time.perf_counter() - t0) * 1e3)
    print(f"{label} chunk wall ms, in turns plain / kernels / kernels / plain: "
          f"{walls['plain'][0]:.1f} / {walls['kernels'][0]:.1f} / {walls['kernels'][1]:.1f} / "
          f"{walls['plain'][1]:.1f}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_chunk(model, scene, r, ts, ts, None, fine_grid, sfm_grid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the renderer's spans are ranges on the device timeline, not kernels;
    # CPU-side ops carry their kernels' time too, so only device events count
    spans = {}  # a span is listed twice: its CPU range and its device range
    for e in events:
        if e.key.startswith("render."):
            spans[e.key] = max(spans.get(e.key, 0.0), e.device_time_total / 1e3)
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("render.")]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    kernels = sum(e.count for e in device)
    print(f"profile {label} chunk of {r.shape[0]} rays: wall {wall_ms:.1f} ms, {kernels} kernels "
          f"busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %); device-timeline ms by span: "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(spans.items())))
    print(events.table(sort_by="self_device_time_total", row_limit=15))


# ------------------------------- training -------------------------------


def training_rays(n_cams: int = TRAIN_CAMS, wh=IMG_WH, seed: int = SEED):
    """Ray-cache rows (N, 12) [o, d, near, far, ts, label, depth, weight]
    and rgbs (N, 3) from ring cameras around the unit sphere, SFM units.
    near / far are each ray's chord of the bounding sphere |x| = 2 (the
    training sphere), as the ray cache stores them; the colour is a numpy
    Lambertian shading of the sphere, the sky behind it. Labels: 'sky'
    where a ray misses, 'person' on the sphere's lower cap, 'building'
    elsewhere; every fourth ray that hits carries its SFM depth with
    weight 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    light = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    rows, rgbs = [], []
    for cam in range(n_cams):
        ang = 2 * np.pi * cam / n_cams + rng.uniform(0, 0.1)
        eye = np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 0.6 + rng.uniform(-0.2, 0.2)])
        o, d = camera_rays(wh, 1.2 * wh[0], eye)
        b = np.sum(o * d, axis=-1)
        c2 = np.sum(o * o, axis=-1)
        near = -b - np.sqrt(np.maximum(b * b - c2 + 4.0, 0.0))
        far = -b + np.sqrt(np.maximum(b * b - c2 + 4.0, 0.0))
        disc = b * b - c2 + 1.0
        hit = disc > 0
        t_hit = np.where(hit, -b - np.sqrt(np.maximum(disc, 0.0)), 0.0)
        p = o + d * t_hit[:, None]
        shade = 0.15 + 0.85 * np.clip(p @ light, 0.0, None)
        rgb = np.where(hit[:, None], np.array([0.8, 0.6, 0.4]) * shade[:, None],
                       np.array([0.55, 0.7, 0.95]))
        label = np.where(hit, np.where(p[:, 2] < -0.6, LABEL_PERSON, LABEL_BUILDING), LABEL_SKY)
        weight = (hit & (np.arange(len(o)) % 4 == 0)).astype(np.float64)
        n = len(o)
        rows.append(np.concatenate([o, d, near[:, None], far[:, None], np.full((n, 1), cam),
                                    label[:, None], t_hit[:, None], weight[:, None]], axis=1))
        rgbs.append(rgb)
    return (np.concatenate(rows).astype(np.float32), np.concatenate(rgbs).astype(np.float32))


class GradCapture:
    """Stands in for the optimiser of a TrainState: keeps one step's gradients."""

    def __init__(self, model):
        self.model, self.grads = model, None

    def zero_grad(self):
        self.model.zero_grad(set_to_none=True)

    def step(self):
        import torch

        self.grads = {k: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                      for k, p in self.model.named_parameters()}


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))


def vjp_kernel_phase(model, fc):
    """K3 and K4 + K5 against their plain version (``ops/field_vjp_math.py``)
    on the live copy of the SDF net at the full width; the backward also
    against the plain version in float64. Then the times at the steady
    phase's shape (8192 rays x 30 samples): kernels forward + backward,
    the plain version, and the torch double backward ('vjp')."""
    import torch

    from neuralrecon_w_tpu_torch.models.layers import layer_weight
    from neuralrecon_w_tpu_torch.models.sdf import sdf_value_feat_grad
    from neuralrecon_w_tpu_torch.ops import field_vjp_math as fvm
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    net = live_sdf_net(model.neuconw.sdf_net)
    dev = net.lin0.bias.device
    cfg = dict(fc.sdf)
    args = (tuple(cfg["skip_in"]), cfg["multires"], float(cfg["scale"]))
    ws = [layer_weight(net.layer(l)).detach().contiguous() for l in range(net.n_layers)]
    bs = [net.layer(l).bias.detach() for l in range(net.n_layers)]
    g = torch.Generator(device="cpu").manual_seed(SEED + 7)

    def inputs(n):
        x = ((torch.rand(n, 3, generator=g) * 2 - 1) * 0.9).to(dev)
        return x, torch.randn(n, ws[-1].shape[0], generator=g).to(dev), \
            torch.randn(n, 3, generator=g).to(dev)

    res, fails = {}, []
    x, c_out, c_grad = inputs(VJP_CHECK_PTS)
    for act in ("float32", "bfloat16"):
        act_t = getattr(torch, act)
        out, grad = vjp.sdf_vjp_fwd(ws, bs, cfg, x, act)
        w_out, w_grad = fvm.value_and_grad(ws, bs, *args, x, act_t)
        torch.cuda.synchronize()
        if act == "float32":
            ok = all(bool(((a - b).abs() <= K3_F32_TOL + K3_F32_TOL * b.abs()).all())
                     for a, b in ((out, w_out), (grad, w_grad)))
        else:
            ok = (float((out[:, 0] - w_out[:, 0]).abs().max()) <= K1_BF16_ATOL
                  and max(rel_l2(out, w_out), rel_l2(grad, w_grad)) <= VJP_BF16_REL)
        err = max(float((out - w_out).abs().max()), float((grad - w_grad).abs().max()))
        print(f"K3 sdf_vjp_fwd {act} on {VJP_CHECK_PTS} pts: max|err| {err:.3e}, rel-L2 out "
              f"{rel_l2(out, w_out):.3e} grad {rel_l2(grad, w_grad):.3e} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"K3 {act}")
        if act == fc.act_dtype:
            res["sdf_vjp_fwd"] = {"max_abs_err": err}

        got = vjp.sdf_vjp_bwd(ws, bs, cfg, x, c_out, c_grad, act)
        plain = fvm.vjp(ws, bs, *args, x, c_out, c_grad, act_t)
        flat = lambda r: [*r[0], *r[1], r[2]]  # noqa: E731
        names = ([f"dW{l}" for l in range(len(ws))] + [f"db{l}" for l in range(len(ws))]
                 + ["dx"])
        if act == "float32":
            truth = fvm.vjp([w.double() for w in ws], [b.double() for b in bs], *args,
                            x.double(), c_out.double(), c_grad.double(), torch.float64)
            rows = [(n, rel_l2(k, t), rel_l2(p, t))
                    for n, k, p, t in zip(names, flat(got), flat(plain), flat(truth))]
            bad = [n for n, k, p in rows if k > max(2 * p, 1e-5)]
            print(f"K4+K5 sdf_vjp_bwd f32 on {VJP_CHECK_PTS} pts, rel-L2 to f64 kernel / plain: "
                  + ", ".join(f"{n} {k:.2e}/{p:.2e}" for n, k, p in rows)
                  + f" -> {'ok' if not bad else 'FAIL ' + str(bad)}")
        else:
            rows = [(n, rel_l2(k, p)) for n, k, p in zip(names, flat(got), flat(plain))]
            bad = [n for n, e in rows if e > VJP_BF16_REL]
            print(f"K4+K5 sdf_vjp_bwd bf16 on {VJP_CHECK_PTS} pts, rel-L2 to plain bf16: "
                  + ", ".join(f"{n} {e:.2e}" for n, e in rows)
                  + f" -> {'ok' if not bad else 'FAIL ' + str(bad)}")
        if bad:
            fails.append(f"K4+K5 {act}")
        if act == fc.act_dtype:
            err = max(float((k - p).abs().max()) for k, p in zip(flat(got), flat(plain)))
            res["sdf_vjp_bwd"], res["dw_reduce"] = {"max_abs_err": err}, {"max_abs_err": err}

    # times at the steady phase's shape, in the served dtype
    x, c_out, c_grad = inputs(VJP_TIME_PTS)
    act = fc.act_dtype
    act_t = getattr(torch, act)
    dnet = copy.deepcopy(net).requires_grad_(True)

    def kern():
        vjp.sdf_vjp_fwd(ws, bs, cfg, x, act)
        vjp.sdf_vjp_bwd(ws, bs, cfg, x, c_out, c_grad, act)

    def plain():
        fvm.value_and_grad(ws, bs, *args, x, act_t)
        fvm.vjp(ws, bs, *args, x, c_out, c_grad, act_t)

    def double_backward():
        xx = x.clone().requires_grad_(True)
        s, f, gr = sdf_value_feat_grad(dnet, cfg, xx, act_t, create_graph=True)
        (torch.sum(s * c_out[:, 0]) + torch.sum(f.float() * c_out[:, 1:])
         + torch.sum(gr * c_grad)).backward()

    t_k = cuda_ms(kern, reps=2)
    t_p = cuda_ms(plain, reps=2)
    t_d = cuda_ms(double_backward, reps=2)
    t_k2 = cuda_ms(kern, reps=2)
    t_fwd = cuda_ms(lambda: vjp.sdf_vjp_fwd(ws, bs, cfg, x, act), reps=2)
    t_fwd_p = cuda_ms(lambda: fvm.value_and_grad(ws, bs, *args, x, act_t), reps=2)
    t_bwd = cuda_ms(lambda: vjp.sdf_vjp_bwd(ws, bs, cfg, x, c_out, c_grad, act), reps=2)
    t_bwd_p = cuda_ms(lambda: fvm.vjp(ws, bs, *args, x, c_out, c_grad, act_t), reps=2)
    t_k5, t_k5_p = time_reduce(ws, bs, cfg, act, VJP_TIME_PTS)
    print(f"SDF-VJP {act} at {VJP_TIME_PTS} pts, ms forward + backward in turns: kernels "
          f"{t_k:.2f} / {t_k2:.2f}, plain {t_p:.2f}, torch double backward {t_d:.2f}; "
          f"forward K3 {t_fwd:.2f} / plain {t_fwd_p:.2f}; backward K4 + K5 {t_bwd:.2f} / plain "
          f"{t_bwd_p:.2f}, of which the dW reduction K5 {t_k5:.2f} / plain products {t_k5_p:.2f}")
    # work per point: F (every layer), G (the reverse sweep, no product for
    # the last layer's seed), the adjoint of G and the backward of F; K5
    # reduces two products per layer from four factor rows per layer
    dims = [(w.shape[1], w.shape[0]) for w in ws]
    f_all, f_hidden = gemm_flops(dims), gemm_flops(dims[:-1])
    n, n_out = VJP_TIME_PTS, dims[-1][1]
    wb = nbytes(*ws, *bs) // 2 if act == "bfloat16" else nbytes(*ws, *bs)
    res["sdf_vjp_fwd"].update(ms=t_fwd, plain_ms=t_fwd_p, library_ms=None,
                              **bound(n * (f_all + f_hidden), wb + n * (12 + 4 * n_out + 12), act))
    res["sdf_vjp_bwd"].update(ms=t_bwd - t_k5, plain_ms=t_bwd_p, library_ms=None,
                              double_backward_ms=t_d, fwd_bwd_ms=min(t_k, t_k2),
                              plain_fwd_bwd_ms=t_p,
                              **bound(n * (f_hidden + 2 * f_hidden + f_all),
                                      wb + n * (12 + 4 * n_out + 12 + 12), act))
    res["dw_reduce"].update(ms=t_k5, plain_ms=t_k5_p, library_ms=None,
                            **bound(n * 2 * f_all, n * 4 * sum(2 * (k + m) for k, m in dims),
                                    act))
    return res, fails


def time_reduce(ws, bs, cfg, act, n_pts):
    """K5 alone over the chunks of one backward of n_pts points, and the
    same dW products in torch (the plain version's) on the same workspace."""
    import torch

    from neuralrecon_w_tpu_torch.ops import field_vjp_math as fvm
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    pk = vjp.pack_vjp_weights(ws, bs, cfg, act)
    n_layers = len(pk.k)
    work, rows = vjp.workspace(n_pts, 6, n_layers, ws[0].device)
    work.normal_()
    view = work.view(6, n_layers, rows, vjp.WMAX)
    chunks = [min(vjp.CHUNK, n_pts - c0) for c0 in range(0, n_pts, vjp.CHUNK)]
    dWs = [torch.zeros(n, k, device=work.device) for n, k in zip(pk.n, pk.k)]
    dbs = [torch.zeros(n, device=work.device) for n in pk.n]
    act_t = getattr(torch, act)

    def kernel():
        for m in chunks:
            for l in range(n_layers):
                vjp.dw_reduce(pk, work, rows, l, m, dWs[l], dbs[l])

    def plain():  # kinds u, z, d, a, r_hat, g_tot (csrc/sdf_vjp.cu)
        for m in chunks:
            for l, (n, k) in enumerate(zip(pk.n, pk.k)):
                dWs[l] += (fvm._mm(view[2, l, :m, :n].t(), view[4, l, :m, :k], act_t)
                           + fvm._mm(view[5, l, :m, :n].t(), view[0, l, :m, :k], act_t))
                dbs[l] += view[5, l, :m, :n].sum(dim=0)

    return cuda_ms(kernel, reps=2), cuda_ms(plain, reps=2)


def train_config(cfg, grad_mode: str, act: str = None):
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg

    fc = field_config_from_cfg(cfg)._replace(grad_mode=grad_mode)
    return fc._replace(act_dtype=act) if act else fc


def make_steps(cfg, fc, fine_level: int):
    from neuralrecon_w_tpu_torch.config import render_config_from_cfg
    from neuralrecon_w_tpu_torch.datasets.mask_utils import get_label_id_mapping
    from neuralrecon_w_tpu_torch.training.losses import loss_config_from_cfg
    from neuralrecon_w_tpu_torch.training.step import make_train_step

    rcfg = render_config_from_cfg(cfg, sfm_level=-1, fine_level=fine_level,
                                  nerf_far_override=False)
    lid = get_label_id_mapping()
    return make_train_step(fc, rcfg, loss_config_from_cfg(cfg), int(cfg.NEUCONW.ANNEAL_END),
                           tuple(lid[x] for x in cfg.NEUCONW.RAY_MASK_LIST),
                           seed=int(cfg.TRAINER.SEED) + 1)


def training_phase(cfg, state, scene, pool, fine_grid, fine_level, label, n_timed=TRAIN_TIMED):
    """Steps of the training path at batch TRAIN_BATCH: one untimed step per
    grad mode, then timed steps in turns, 'pallas' / 'vjp' / 'vjp' /
    'pallas', each block n_timed // 2 steps. Returns (rays/s per mode,
    the last aux per mode, fails)."""
    import torch

    steps = {m: make_steps(cfg, train_config(cfg, m), fine_level) for m in ("pallas", "vjp")}
    seconds = {m: 0.0 for m in steps}
    counts = {m: 0 for m in steps}
    aux, fails = {}, []
    for mode in ("pallas", "vjp"):
        _, aux[mode] = steps[mode](state, scene, pool.next_batch(TRAIN_BATCH), fine_grid)
    for mode in ("pallas", "vjp", "vjp", "pallas"):
        for _ in range(n_timed // 2):
            batch = pool.next_batch(TRAIN_BATCH)
            sync()
            t0 = time.perf_counter()
            _, aux[mode] = steps[mode](state, scene, batch, fine_grid)
            sync()
            seconds[mode] += time.perf_counter() - t0
            counts[mode] += 1
            bad = [k for k, v in aux[mode].items() if not bool(torch.isfinite(v))]
            if bad:
                fails.append(f"{label} {mode} step {state.step}: {bad} not finite")
    rps = {m: counts[m] * TRAIN_BATCH / seconds[m] for m in steps}
    print(f"training {label}: {counts['pallas']} + {counts['vjp']} timed steps of "
          f"{TRAIN_BATCH} rays: rays/s pallas {rps['pallas']:.1f}, vjp {rps['vjp']:.1f}; loss "
          f"{float(aux['pallas']['loss']):.4f}, psnr {float(aux['pallas']['psnr']):.2f}, "
          "terms " + ", ".join(f"{k} {float(v):.4g}" for k, v in aux["pallas"].items()))
    return rps, aux, fails


def profile_step(cfg, state, scene, pool, fine_grid, fine_level, label) -> None:
    """torch.profiler over one warm training step per grad mode: the
    device time by the step's spans (render and loss, optimiser) and the
    renderer's, the busy share of the wall, the top kernels. The backward
    runs on autograd's own thread, outside the spans: it is the rest of
    the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for mode in ("pallas", "vjp"):
        step = make_steps(cfg, train_config(cfg, mode), fine_level)
        step(state, scene, pool.next_batch(TRAIN_BATCH), fine_grid)
        batch = pool.next_batch(TRAIN_BATCH)
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, scene, batch, fine_grid)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        spans = {}
        for e in events:
            if e.key.startswith(("render.", "train.")):
                spans[e.key] = max(spans.get(e.key, 0.0), e.device_time_total / 1e3)
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith(("render.", "train."))]
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
        top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
        print(f"profile training {label} {mode} step of {TRAIN_BATCH} rays: wall {wall_ms:.1f} ms, "
              f"{sum(e.count for e in device)} kernels busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f} %); device-timeline ms by span: "
              + ", ".join(f"{k} {v:.1f}" for k, v in sorted(spans.items())))
        print("  top kernels, self device ms: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} (x{e.count})" for e in top))


def step_parity(cfg, model, scene, batch, fine_grid, fine_level, label, step: int = 3):
    """From one copy of the model and one batch, one step in 'pallas' and
    one in 'vjp', in f32 and in the served dtype: the losses and every
    parameter gradient. In f32 the two modes are held to each other; in
    bf16 each is held to the f32 'vjp' gradient (PARITY_BF16_*)."""
    from neuralrecon_w_tpu_torch.training.step import TrainState

    fails, ref = [], None
    for act in dict.fromkeys(("float32", train_config(cfg, "vjp").act_dtype)):
        out = {}
        for mode in ("pallas", "vjp"):
            m = copy.deepcopy(model)
            st = TrainState(m, GradCapture(m), step)
            _, aux = make_steps(cfg, train_config(cfg, mode, act), fine_level)(
                st, scene, batch, fine_grid)
            out[mode] = (aux, st.optimizer.grads)
        (a_k, g_k), (a_v, g_v) = out["pallas"], out["vjp"]
        errs = {k: rel_l2(g_k[k], g_v[k]) for k in g_v}
        if act == "float32":
            ref, (loss_tol, bound) = g_v, PARITY_F32
            bounds = dict.fromkeys(g_v, bound)
            rule = f"bound {bound}"
        else:
            loss_tol = PARITY_BF16_LOSS
            e_k = {k: rel_l2(g_k[k], ref[k]) for k in g_v}
            e_v = {k: rel_l2(g_v[k], ref[k]) for k in g_v}
            bounds = {k: max(PARITY_BF16_RATIO * e_v[k], PARITY_BF16_FLOOR) for k in g_v}
            errs = e_k
            rule = (f"to f32 'vjp', bound max({PARITY_BF16_RATIO} x vjp's, "
                    f"{PARITY_BF16_FLOOR}); pallas / vjp / between the modes")
        loss_bad = [k for k in a_v if abs(float(a_k[k]) - float(a_v[k]))
                    > loss_tol * abs(float(a_v[k])) and k not in ("psnr", "s_val")]
        bad = sorted(k for k, e in errs.items() if e > bounds[k])
        worst = sorted(errs, key=lambda k: -errs[k] / bounds[k])[:4]
        show = ((lambda k: f"{errs[k]:.2e}") if act == "float32" else
                (lambda k: f"{e_k[k]:.2e}/{e_v[k]:.2e}/{rel_l2(g_k[k], g_v[k]):.2e}"))
        print(f"parity {label} {act}, pallas vs vjp: losses "
              + ", ".join(f"{k} {float(a_k[k]):.6g}/{float(a_v[k]):.6g}" for k in a_v)
              + f"; grad rel-L2 ({rule}), nearest their bound: "
              + ", ".join(f"{k} {show(k)}" for k in worst))
        print("  grad rel-L2 of the SDF net: " + ", ".join(
            f"{k.split('sdf_net.')[1]} {show(k)}" for k in errs if "sdf_net" in k))
        if loss_bad or bad:
            fails.append(f"parity {label} {act}: losses {loss_bad}, grads {bad}")
    return fails


# ------------------------------- extraction -------------------------------


def unit_directions(n: int, seed: int = SEED):
    import numpy as np

    v = np.random.default_rng(seed + 11).standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def zero_set_points(model, fc, n: int, seed: int = SEED):
    """Up to n points on the field's zero set, unit coordinates. Along
    ZERO_DIRS * n seeded unit directions the SDF (K1 in f32) is scanned at
    ZERO_SCAN's radii; the first sign change brackets a crossing, bisected
    to BISECT_TOL. Returns (the first n crossings (n', 3) float64, the
    number of directions scanned without one, a line on the radial
    profile)."""
    import torch

    from neuralrecon_w_tpu_torch.ops.sdf_mlp import fused_sdf_head, pack_sdf_weights

    packed = pack_sdf_weights(model.neuconw.sdf_net, fc.sdf, "float32")
    dev = packed.w.device
    d = torch.from_numpy(unit_directions(int(math.ceil(ZERO_DIRS * n)), seed)).float().to(dev)

    def sdf(r):
        return fused_sdf_head(packed, (d * r[:, None]).contiguous())

    radii = torch.linspace(*ZERO_SCAN, device=dev)
    scan = torch.stack([sdf(torch.full((len(d),), float(r), device=dev)) for r in radii], 1)
    change = (scan[:, 1:] < 0) != (scan[:, :-1] < 0)
    crosses = change.any(1)
    first = change.float().argmax(1)
    profile = "; ".join(
        f"r {float(radii[k]):.2f}: " + "/".join(f"{float(q):.3g}" for q in torch.quantile(
            scan[:, k], torch.tensor([0.0, 0.5, 1.0], device=dev)))
        for k in (0, len(radii) // 4, len(radii) // 2, 3 * len(radii) // 4, len(radii) - 1))
    keep = torch.nonzero(crosses)[:n, 0]
    d, first = d[keep], first[keep]
    lo, hi = radii[first], radii[first + 1]
    lo_neg = sdf(lo) < 0
    while len(d) and float((hi - lo).max()) > BISECT_TOL:
        mid = (lo + hi) / 2
        same = (sdf(mid) < 0) == lo_neg
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    r = (lo + hi) / 2
    return (d * r[:, None]).double().cpu().numpy(), int((~crosses).sum()), profile


def write_workspace(root: str, sfm_points, radius: float = 2.0, sfm_voxel: float = SFM_VOXEL,
                    min_track: int = MIN_TRACK) -> dict:
    """A phototourism-style workspace: ``config.yaml`` (origin 0, the scene
    radius, identity sfm2gt, eval_bbx +-1.5, the SFM voxel size,
    min_track_length) and ``dense/sparse/points3D.bin``, every point with a
    track of min_track + 1 observations. Returns the scene config."""
    import numpy as np
    import yaml

    from neuralrecon_w_tpu_torch.datasets.colmap import Point3D, write_points3d_binary

    os.makedirs(os.path.join(root, "dense", "sparse"), exist_ok=True)
    scene = {"name": "zero_set", "origin": [0.0, 0.0, 0.0], "radius": float(radius),
             "sfm2gt": np.eye(4).tolist(), "eval_bbx": [[-1.5] * 3, [1.5] * 3],
             "voxel_size": float(sfm_voxel), "min_track_length": int(min_track)}
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(scene, f)
    track = np.arange(min_track + 1, dtype=np.int32)
    rgb = np.full(3, 128, np.uint8)
    points = {i + 1: Point3D(i + 1, p, rgb, 0.5, track, track) for i, p in enumerate(sfm_points)}
    write_points3d_binary(points, os.path.join(root, "dense", "sparse", "points3D.bin"))
    return scene


def write_cfg(path: str, root: str, extra: dict | None = None) -> str:
    """A cfg yaml over the operating point with DATASET.ROOT_DIR = root."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump({"_BASE_": CONFIG, "DATASET": {"ROOT_DIR": root}, **(extra or {})}, f)
    return path


def extraction_workspace(model, fc, root: str, n_points: int = EXTRACT_POINTS,
                         extra_cfg: dict | None = None, step: int = 0,
                         sfm_voxel: float = SFM_VOXEL):
    """SFM points on ``model``'s zero set, the workspace (its scene radius
    puts the farthest point EXTRACT_REACH from the origin), ``model`` saved
    with save_checkpoint, and the cfg: (cfg path, checkpoint path, scene
    config, fails)."""
    import numpy as np

    from neuralrecon_w_tpu_torch.training.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    pts, none, profile = zero_set_points(model, fc, n_points)
    sync()
    t1 = time.perf_counter()
    print(f"field's SDF along {int(math.ceil(ZERO_DIRS * n_points))} seeded directions "
          f"(min/median/max): {profile}")
    if len(pts) < n_points:
        return None, None, None, [f"only {len(pts)} of {n_points} directions cross the zero set"]
    r = np.linalg.norm(pts, axis=1)
    radius = EXTRACT_REACH / float(r.max())
    scene = write_workspace(root, pts * radius, radius, sfm_voxel)
    ckpt = save_checkpoint(os.path.join(root, "results", "checkpoints", "last.ckpt"), model, step)
    cfg_path = write_cfg(os.path.join(root, "extract.yaml"), root, extra_cfg)
    print(f"extraction workspace: {n_points} SFM points on the field's zero set at |x| "
          f"{r.min():.4f}-{r.max():.4f} unit ({none} directions without a crossing; scan and "
          f"bisection {t1 - t0:.2f} s), scene radius {radius:.4f}, written with the checkpoint "
          f"in {time.perf_counter() - t1:.2f} s")
    return cfg_path, ckpt, scene, []


def run_extraction(cfg_path: str, ckpt: str, level: int = EXTRACT_LEVEL, device: str = "cuda"):
    """``tools/extract_mesh_cli.main`` with the flags of scripts/sdf_extract.sh."""
    from neuralrecon_w_tpu_torch.tools import extract_mesh_cli

    return extract_mesh_cli.main(["--cfg_path", cfg_path, "--ckpt_path", ckpt, "--eval_level",
                                  str(level), "--mesh_size", "1024", "--chunk",
                                  str(EXTRACT_CHUNK), "--vertex_color", "--device", device])


def check_mesh(model, fc, res, ckpt: str, radius: float, level: int = EXTRACT_LEVEL):
    """The written ply: where the CLI names it, non-empty, finite, inside the
    eval bbx, unit normals, faces in range; its vertices on the field's zero
    set: median |sdf| (K1 in f32) within SDF_PROBE_CELLS level-``level``
    cells. ``radius`` is the workspace's scene radius. Returns (fails,
    median |sdf| in cells)."""
    import numpy as np

    from neuralrecon_w_tpu_torch.ops.sdf_mlp import fused_sdf_head, pack_sdf_weights
    from neuralrecon_w_tpu_torch.parallel.sweep import sweep
    from neuralrecon_w_tpu_torch.utils.ply import read_ply

    if res is None:
        return ["extraction found an empty surface"], float("nan")
    want = os.path.join(os.path.dirname(os.path.dirname(ckpt)),
                        f"extracted_mesh_level_{level}_colored.ply")
    ply = read_ply(res.path)
    v, nrm, col, faces = ply["verts"], ply["normals"], ply["colors"], ply["faces"]
    fails = [] if res.path == want else [f"ply at {res.path}, expected {want}"]
    if len(v) == 0 or len(faces) == 0:
        return fails + ["empty mesh"], float("nan")
    if not (np.isfinite(v).all() and np.isfinite(nrm).all()):
        fails.append("mesh vertices or normals not finite")
    if np.abs(v).max() > 1.5:
        fails.append("mesh vertices outside the eval bbx")
    # vertex_normals leaves a normal short of unit where the area of the
    # vertex's faces sums below its 1e-12 floor: slivers, where the surface
    # passes within ~1e-7 of a cell corner
    norm = np.linalg.norm(nrm, axis=-1)
    short = int((np.abs(norm - 1.0) > 1e-3).sum())
    if norm.max() > 1.0 + 1e-3 or short > NORMAL_SHORT_FRAC * len(v):
        fails.append(f"mesh normals not unit: {short} short, longest {norm.max():.6f}")
    if col.shape != v.shape or faces.min() < 0 or faces.max() >= len(v):
        fails.append("mesh colours or faces malformed")
    packed = pack_sdf_weights(model.neuconw.sdf_net, fc.sdf, "float32")
    dev = packed.w.device
    sdf = sweep(lambda b: fused_sdf_head(packed, b), EXTRACT_CHUNK,
                (v / radius).astype(np.float32), device=dev)
    cell = res.grid.voxel_size / radius  # level-``level`` cell, unit coordinates
    med = float(np.median(np.abs(sdf))) / cell
    print(f"mesh: {len(v)} verts, {len(faces)} faces, colours in [{col.min()}, {col.max()}], "
          f"{short} normals short of unit; "
          f"|sdf| at the vertices (K1 f32): median {med:.3e} cells, max "
          f"{float(np.abs(sdf).max()) / cell:.3e} cells (cell {cell:.3e} unit)")
    if not med <= SDF_PROBE_CELLS:
        fails.append(f"mesh vertices off the zero set: median |sdf| {med:.3e} cells")
    return fails, med


def extraction_sweep_checks(model, fc, res, radius: float):
    """The path's device sweeps against the plain versions: the SDF at every
    grid point (K1 f32 against its plain f32 version), and the vertex
    colours the path wrote (K6) against the plain version's, in uint8."""
    import numpy as np

    from neuralrecon_w_tpu_torch.ops import field_forward as ff
    from neuralrecon_w_tpu_torch.ops.sdf_mlp import fused_sdf_head, pack_sdf_weights, sdf_mlp_plain
    from neuralrecon_w_tpu_torch.parallel.sweep import sweep

    fails = []
    packed = pack_sdf_weights(model.neuconw.sdf_net, fc.sdf, "float32")
    dev = packed.w.device
    pts = (res.grid.points_sfm / radius).astype(np.float32)
    got = sweep(lambda b: fused_sdf_head(packed, b), EXTRACT_CHUNK, pts, device=dev)
    want = sweep(lambda b: sdf_mlp_plain(packed, b), EXTRACT_CHUNK, pts, device=dev)
    err = np.abs(got - want)
    ok = bool((err <= K1_F32_ATOL + K1_F32_RTOL * np.abs(want)).all())
    print(f"SDF sweep at {len(pts)} grid points, K1 f32 vs plain: max|err| {err.max():.3e} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fails.append("extraction SDF sweep, K1 vs plain")

    verts = (res.mesh.verts / radius).astype(np.float32)
    n = len(verts)
    a = model.embedding_a.weight[min(1123, model.embedding_a.weight.shape[0] - 1)]
    a = a.detach().float().cpu().numpy()
    pack = ff.pack_field(model, fc)
    plain = sweep(lambda p, d, e: ff.field_forward_plain(pack, p, d, e)[0], COLOR_CHUNK, verts,
                  np.broadcast_to(np.float32([0, 0, 1]), (n, 3)).copy(),
                  np.broadcast_to(a, (n, a.shape[0])).copy(), device=dev)
    plain = np.clip(plain * 255.0, 0, 255).astype(np.uint8)
    diff = np.abs(plain.astype(np.int16) - res.mesh.colors.astype(np.int16)).max(axis=1)
    frac = float((diff <= COLOR_LEVELS).mean())
    print(f"vertex colours at {n} vertices, K6 path vs plain {fc.act_dtype}: within "
          f"{COLOR_LEVELS} levels {frac:.6f}, max {int(diff.max())} -> "
          f"{'ok' if frac >= COLOR_FRAC else 'FAIL'}")
    if frac < COLOR_FRAC:
        fails.append("extraction vertex colours, K6 vs plain")
    return fails


def field_kernel_phase(model, fc):
    """K6 against its plain version on the live field at K6_CHECK_PTS
    points, f32 and bf16, and its times at the colour sweep's chunk in the
    served dtype; K1 in f32 at the SDF sweep's chunk against its plain
    version, and its times."""
    import torch

    from neuralrecon_w_tpu_torch.ops import field_forward as ff
    from neuralrecon_w_tpu_torch.ops import sdf_mlp

    live = live_field(model)
    dev = next(live.parameters()).device
    g = torch.Generator(device="cpu").manual_seed(SEED + 13)
    n = K6_CHECK_PTS
    pts = ((torch.rand(n, 3, generator=g) * 2 - 1) * 0.9).to(dev)
    dirs = torch.randn(n, 3, generator=g)
    dirs = (dirs / dirs.norm(dim=-1, keepdim=True)).to(dev)
    a = torch.randn(n, fc.n_a, generator=g).to(dev)
    res, fails = {}, []
    for act in ("float32", "bfloat16"):
        fca = fc._replace(act_dtype=act)
        pack = ff.pack_field(live, fca)
        got = ff.field_forward_kernel(pack, pts, dirs, a)
        want = ff.field_forward_plain(pack, pts, dirs, a)
        torch.cuda.synchronize()
        errs = [float((k - p).abs().max()) for k, p in zip(got, want)]
        rels = [rel_l2(k, p) for k, p in zip(got, want)]
        if act == "float32":
            ok = all(bool(((k - p).abs() <= K3_F32_TOL + K3_F32_TOL * p.abs()).all())
                     for k, p in zip(got, want))
        else:
            ok = max(rels) <= VJP_BF16_REL
        ok = ok and all(bool(torch.isfinite(k).all()) for k in got)
        print(f"K6 field_fwd {act} on {n} pts, rgb / sdf / grad: max|err| "
              + " / ".join(f"{e:.3e}" for e in errs) + ", rel-L2 "
              + " / ".join(f"{r:.3e}" for r in rels) + f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"K6 {act}")
        if act == fc.act_dtype:
            res["field_fwd"] = {"max_abs_err": max(errs)}
            t_k = cuda_ms(lambda: ff.field_forward_kernel(pack, pts, dirs, a))
            t_p = cuda_ms(lambda: ff.field_forward_plain(pack, pts, dirs, a))
            t_k2 = cuda_ms(lambda: ff.field_forward_kernel(pack, pts, dirs, a))
            sp, cp = pack.sdf, pack.color
            sdf_dims = list(zip(sp.k, sp.n))
            flops = n * (gemm_flops(sdf_dims) + gemm_flops(sdf_dims[:-1])
                         + gemm_flops(zip(cp.k, cp.n)))
            b = bound(flops, nbytes(pts, dirs, a, sp.w, sp.b, cp.w, cp.b) + n * 28, act)
            res["field_fwd"].update(ms=min(t_k, t_k2), plain_ms=t_p, library_ms=None, **b)
            print(f"K6 field_fwd {act} at {n} pts: kernel {t_k:.3f} / {t_k2:.3f} ms, plain "
                  f"{t_p:.3f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']})")

    # K1 in f32 at the SDF sweep's chunk
    packed = sdf_mlp.pack_sdf_weights(live.neuconw.sdf_net, fc.sdf, "float32")
    x = ((torch.rand(EXTRACT_CHUNK, 3, generator=g) * 2 - 1) * 0.9).to(dev)
    err = float((sdf_mlp.fused_sdf_head(packed, x) - sdf_mlp.sdf_mlp_plain(packed, x)).abs().max())
    t_k = cuda_ms(lambda: sdf_mlp.fused_sdf_head(packed, x))
    t_p = cuda_ms(lambda: sdf_mlp.sdf_mlp_plain(packed, x))
    t_k2 = cuda_ms(lambda: sdf_mlp.fused_sdf_head(packed, x))
    b = bound(EXTRACT_CHUNK * gemm_flops(zip(packed.k, packed.n)),
              nbytes(x, packed.w, packed.b) + 4 * EXTRACT_CHUNK, "float32")
    res["sdf_mlp_f32"] = {"max_abs_err": err, "ms": min(t_k, t_k2), "plain_ms": t_p, **b}
    print(f"K1 sdf_mlp float32 at {EXTRACT_CHUNK} pts: kernel {t_k:.3f} / {t_k2:.3f} ms, plain "
          f"{t_p:.3f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']}), max|err| {err:.3e}")
    return res, fails


def pending_kernel_bounds(model, fc, n_field: int, n_bg: int) -> str:
    """The least times of the two TPU kernels not ported yet, at their
    training path's shapes in the activation dtype: kernel 5, the fused
    field forward and backward at n_field points (K3 + K4 + K5's products
    and the colour head's forward, dX and dW), and kernel 6, the fused
    background forward and backward at n_bg points (every linear's
    forward, dX and dW). Inputs, outputs and their cotangents read or
    written once, dW in float32."""
    from torch import nn

    from neuralrecon_w_tpu_torch.ops import field_forward as ff

    act = fc.act_dtype
    ab = 2 if act == "bfloat16" else 4
    pack = ff.pack_field(model, fc)
    sdf = list(zip(pack.sdf.k, pack.sdf.n))
    col = list(zip(pack.color.k, pack.color.n))
    n_w = sum(k * n for k, n in sdf + col)
    flops = n_field * (gemm_flops(sdf) + gemm_flops(sdf[:-1])  # K3
                       + 3 * gemm_flops(sdf[:-1]) + gemm_flops(sdf)  # K4
                       + 2 * gemm_flops(sdf) + 3 * gemm_flops(col))  # K5, the colour head
    k5 = bound(flops, n_w * (ab + 4) + n_field * 2 * (12 + 12 + 4 * fc.n_a + 28), act)
    bg = [(m.in_features, m.out_features) for m in model.nerf.modules()
          if isinstance(m, nn.Linear)]
    k6 = bound(3 * n_bg * gemm_flops(bg), sum(k * n for k, n in bg) * (ab + 4)
               + n_bg * 2 * (16 + 12 + 4 * fc.n_a + 16), act)
    return (f"bounds of the TPU kernels still to port, {act}: kernel 5 at {n_field} pts "
            f"{k5['bound_ms']:.3f} ms ({k5['bound_by']}), kernel 6 at {n_bg} pts "
            f"{k6['bound_ms']:.3f} ms ({k6['bound_by']})")


def extraction_phase(model, fc, root: str, n_points: int = EXTRACT_POINTS,
                     level: int = EXTRACT_LEVEL, extra_cfg: dict | None = None, step: int = 0,
                     sfm_voxel: float = SFM_VOXEL):
    """The workspace, then the CLI with the launch counts set to 0 just
    before and read just after, then the checks. Returns (launches, fails)."""
    from neuralrecon_w_tpu_torch.ops.field_forward import fused_field_forward
    from neuralrecon_w_tpu_torch.ops.sdf_mlp import fused_sdf_head

    cfg_path, ckpt, scene, fails = extraction_workspace(model, fc, root, n_points, extra_cfg,
                                                        step, sfm_voxel)
    if fails:
        return {"sdf_mlp": 0, "field_fwd": 0}, fails
    dev = next(model.parameters()).device.type
    fused_sdf_head.launches = fused_field_forward.launches = 0
    sync()
    t0 = time.perf_counter()
    res = run_extraction(cfg_path, ckpt, level, dev)
    sync()
    wall = time.perf_counter() - t0
    launches = {"sdf_mlp": fused_sdf_head.launches, "field_fwd": fused_field_forward.launches}
    print(f"launches in extraction: K1 sdf_mlp {launches['sdf_mlp']}, K6 field_fwd "
          f"{launches['field_fwd']}; CLI wall {wall:.2f} s")
    if dev == "cuda":
        fails += [f"{k} not launched in extraction" for k, v in launches.items() if v <= 0]
    radius = float(scene["radius"])
    mesh_fails, _ = check_mesh(model, fc, res, ckpt, radius, level)
    fails += mesh_fails
    if res is not None:
        sec = res.seconds
        n_grid, n_verts = len(res.grid.points_sfm), len(res.mesh.verts)
        print(f"extraction stages, s: " + ", ".join(f"{k} {v:.3f}" for k, v in sec.items())
              + f"; SDF sweep {n_grid / sec['sdf sweep']:.4g} points/s over {n_grid} grid "
              f"points, colour sweep {n_verts / sec['colour sweep']:.4g} points/s over "
              f"{n_verts} vertices")
        if not mesh_fails:
            fails += extraction_sweep_checks(model, fc, res, radius)
    return launches, fails


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="time one chunk per serving phase plain / kernels and profile "
                        "it, and profile one training step per phase and grad mode")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from neuralrecon_w_tpu_torch.config import (
        field_config_from_cfg, load_cfg, render_config_from_cfg)
    from neuralrecon_w_tpu_torch.ops import build, native
    from neuralrecon_w_tpu_torch.ops.importance_sampler import up_sample_round
    from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
    from neuralrecon_w_tpu_torch.ops.sdf_mlp import fused_sdf_head
    from neuralrecon_w_tpu_torch.datasets.cache import RayPool
    from neuralrecon_w_tpu_torch.ops.sdf_field_vjp import dw_reduce, sdf_vjp_bwd, sdf_vjp_fwd
    from neuralrecon_w_tpu_torch.tools.convert import init_field
    from neuralrecon_w_tpu_torch.training.schedule import make_optimizer
    from neuralrecon_w_tpu_torch.training.step import init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    path, secs, log = build.build()
    print(f"built {os.path.relpath(path, ROOT)} in {secs:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    build.kernels()
    t0 = time.perf_counter()
    print(f"built {os.path.relpath(native.build(), ROOT)} (the host mesher) in "
          f"{time.perf_counter() - t0:.1f} s")

    cfg = load_cfg(CONFIG)
    fc = field_config_from_cfg(cfg)
    model = init_field(fc, torch.Generator().manual_seed(SEED), dev).eval().requires_grad_(False)

    t0 = time.perf_counter()
    scene, sfm_host, fine_host, frames = make_scene(dev)
    sfm_grid = device_grid_from_host(sfm_host, dev)
    fine_grid = device_grid_from_host(fine_host, dev)
    print(f"scene: SFM grid level {sfm_host.level} ({len(sfm_host.coords)} cells), fine grid "
          f"level {fine_host.level} ({len(fine_host.coords)} cells), {len(frames)} frames of "
          f"{IMG_WH[0]}x{IMG_WH[1]}; made in {time.perf_counter() - t0:.1f} s")
    rcfg_warm = render_config_from_cfg(cfg, sfm_level=sfm_host.level, fine_level=-1,
                                       nerf_far_override=True)
    rcfg_steady = rcfg_warm._replace(fine_level=fine_host.level)
    print(f"model: act {fc.act_dtype}, SDF {dict(fc.sdf)['n_layers']}x{dict(fc.sdf)['d_hidden']}; "
          f"sampler fused={rcfg_warm.fused_sampler_sdf}, n_samples {rcfg_warm.n_samples} + "
          f"{rcfg_warm.n_importance} in {rcfg_warm.up_sample_steps} rounds, boundary "
          f"{rcfg_warm.boundary_samples}, bg {rcfg_warm.n_outside} / bg_samples {rcfg_warm.bg_samples}")

    # kernel phase on the first chunk's rays, at the sampler's base z
    from neuralrecon_w_tpu_torch.rendering.renderer import near_far_from_sfm_grid

    rays = torch.as_tensor(frames[0][:CHUNK], device=dev)
    rays_o = (rays[:, :3] - scene.origin) / scene.radius
    near, far, _ = near_far_from_sfm_grid(rcfg_warm, scene, sfm_grid, rays_o, rays[:, 3:6],
                                          rays[:, 6:7] / scene.radius, rays[:, 7:8] / scene.radius)
    z_base = near + (far - near) * torch.linspace(0, 1, 8, device=dev)[None, :]
    kres, fails = kernel_phase(model, fc, rays_o, rays[:, 3:6].contiguous(), z_base.contiguous(),
                               CHUNK * 30)

    # serving: launches are counted from here on
    fused_sdf_head.launches = up_sample_round.launches = 0
    rps_warm, outs_warm = serving_phase(model, fc, rcfg_warm, scene, frames, None, sfm_grid,
                                        "warm-up")
    launches_warm = (fused_sdf_head.launches, up_sample_round.launches)
    rps_steady, outs_steady = serving_phase(model, fc, rcfg_steady, scene, frames, fine_grid,
                                            sfm_grid, "steady")
    launches = {"sdf_mlp": fused_sdf_head.launches, "up_sample": up_sample_round.launches}
    print(f"launches in serving: K1 sdf_mlp {launches['sdf_mlp']} (warm-up {launches_warm[0]}), "
          f"K2 up_sample {launches['up_sample']} (warm-up {launches_warm[1]})")
    for name, warm, total in zip(launches, launches_warm, launches.values()):
        if warm <= 0 or total <= warm:
            fails.append(f"{name} not launched in every serving phase")
    fails += check_frames(outs_warm, frames, "warm-up")
    fails += check_frames(outs_steady, frames, "steady")
    fails += path_check(model, fc, rcfg_warm, scene, frames[1], None, sfm_grid, "warm-up")
    fails += path_check(model, fc, rcfg_steady, scene, frames[1], fine_grid, sfm_grid, "steady")
    print(f"peak device memory after serving {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if args.profile:
        profile_chunk(model, fc, rcfg_warm, scene, frames[1], None, sfm_grid, "warm-up")
        profile_chunk(model, fc, rcfg_steady, scene, frames[1], fine_grid, sfm_grid, "steady")
    print(f"serving rays/s ({card}): warm-up {rps_warm:.1f}, steady {rps_steady:.1f}")

    # the SDF-VJP kernels against their plain version, and their times
    vres, vfails = vjp_kernel_phase(model, fc)
    fails += vfails
    kres.update(vres)

    # training: Adam steps of make_train_step over RayPool batches
    torch.cuda.reset_peak_memory_stats()
    rows, rgbs = training_rays()
    pool = RayPool(rows, rgbs, with_semantics=True, seed=int(cfg.TRAINER.SEED))
    spec, _ = make_optimizer(cfg, TRAIN_BATCH)
    state = init_state(train_config(cfg, "pallas"), spec, torch.Generator().manual_seed(SEED),
                       dev)
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    print(f"training: {len(pool)} rays from {TRAIN_CAMS} ring cameras "
          f"({int((rows[:, 9] == LABEL_SKY).sum())} sky, "
          f"{int((rows[:, 9] == LABEL_PERSON).sum())} person, "
          f"{int((rows[:, 11] > 0).sum())} with depth), batch {TRAIN_BATCH}, lr {spec.schedule}, "
          f"SDF_GRAD_MODE pallas against vjp, act {fc.act_dtype}")
    counters = (fused_sdf_head, up_sample_round, sdf_vjp_fwd, sdf_vjp_bwd, dw_reduce)
    names = ("sdf_mlp", "up_sample", "sdf_vjp_fwd", "sdf_vjp_bwd", "dw_reduce")
    train_launches, rps_train = {n: 0 for n in names}, {}
    for label, fg, level in (("warm-up", None, -1), ("steady", fine_grid, fine_host.level)):
        for c in counters:
            c.launches = 0
        rps_train[label], _, tfails = training_phase(cfg, state, scene, pool, fg, level, label)
        fails += tfails
        got = {n: c.launches for n, c in zip(names, counters)}
        print(f"launches in training {label}: " + ", ".join(f"{n} {v}" for n, v in got.items()))
        for n in names:
            train_launches[n] += got[n]
            if got[n] <= 0:
                fails.append(f"{n} not launched in training {label}")
    moved = [k for k, v in state.model.state_dict().items() if not torch.equal(v, before[k])]
    if len(moved) < len(before) // 2:
        fails.append(f"training moved only {len(moved)} of {len(before)} parameter tensors")
    print(f"training moved {len(moved)} of {len(before)} parameter tensors in {state.step} steps; "
          f"peak device memory in training {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if args.profile:
        profile_step(cfg, state, scene, pool, None, -1, "warm-up")
        profile_step(cfg, state, scene, pool, fine_grid, fine_host.level, "steady")
    batch = pool.next_batch(TRAIN_BATCH)
    fails += step_parity(cfg, state.model, scene, batch, None, -1, "warm-up")
    fails += step_parity(cfg, state.model, scene, batch, fine_grid, fine_host.level, "steady")
    print(f"training rays/s ({card}): " + "; ".join(
        f"{label} pallas {r['pallas']:.1f}, vjp {r['vjp']:.1f}" for label, r in rps_train.items()))

    # extraction: K6 and K1 f32 against their plain versions, then the
    # served field through extract_mesh_cli at level 10. Not the trained
    # one: 28 steps on the synthetic sphere leave it no closed surface
    # (PERF.md, section 6)
    del pool, rows, rgbs, batch, state
    xres, xfails = field_kernel_phase(model, fc)
    fails += xfails
    kres.update(xres)
    print(pending_kernel_bounds(model, fc, VJP_TIME_PTS, TRAIN_BATCH * rcfg_warm.bg_samples))
    torch.cuda.reset_peak_memory_stats()
    root = tempfile.mkdtemp(prefix="extract_", dir=os.path.join(ROOT, "build"))
    try:
        x_launches, xfails = extraction_phase(model, fc, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fails += xfails
    print(f"peak device memory in extraction {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    if fails:
        print("FAILED: " + "; ".join(fails), file=sys.stderr)
        return 1
    vjp_src = "neuralrecon_w_tpu_torch/csrc/sdf_vjp.cu"
    sources = {"sdf_mlp": ("neuralrecon_w_tpu_torch/csrc/sdf_mlp.cu",
                           "neuralrecon_w_tpu/ops/pallas_mlp.py:130"),
               "up_sample": ("neuralrecon_w_tpu_torch/csrc/up_sample.cu",
                             "neuralrecon_w_tpu/ops/pallas_sampler.py:445"),
               "sdf_vjp_fwd": (vjp_src, "neuralrecon_w_tpu/ops/pallas_field_vjp.py:411"),
               "sdf_vjp_bwd": (vjp_src, "neuralrecon_w_tpu/ops/pallas_field_vjp.py:482"),
               "dw_reduce": (vjp_src, "neuralrecon_w_tpu/ops/pallas_field_vjp.py:482"),
               "field_fwd": ("neuralrecon_w_tpu_torch/csrc/field_fwd.cu",
                             "neuralrecon_w_tpu/ops/pallas_field.py:274")}
    # K1 and K2 count the serving path's launches, K3 to K5 the training
    # path's, K6 the extraction's; K1's extraction launches and its f32
    # numbers at the SDF sweep's chunk ride along in its entry
    launches.update({n: train_launches[n] for n in ("sdf_vjp_fwd", "sdf_vjp_bwd", "dw_reduce")})
    launches["field_fwd"] = x_launches["field_fwd"]
    kres["sdf_mlp"]["extraction"] = {"launches": x_launches["sdf_mlp"], **kres.pop("sdf_mlp_f32")}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **kres[name]}
               for name, (src, rep) in sources.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
