#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port's serving path.

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

adds, for one chunk of each phase, the wall time of the plain and the
kernel path in turns and a torch.profiler breakdown by renderer span.

The last lines are the card line, a JSON object with one entry per
kernel, and ``{"ok": true, "device": {...}}``. It exits non-zero, with no
result line, when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import subprocess
import sys
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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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
    res["sdf_mlp"] = {"max_abs_err": k1_err, "ms": min(k1_ms, k1_ms2), "plain_ms": k1_plain}

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
    res["up_sample"] = {"max_abs_err": k2_err, "ms": min(k2_ms, k2_ms2), "plain_ms": k2_plain}

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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="time one chunk per phase plain / kernels and profile it")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from neuralrecon_w_tpu_torch.config import (
        field_config_from_cfg, load_cfg, render_config_from_cfg)
    from neuralrecon_w_tpu_torch.ops import build
    from neuralrecon_w_tpu_torch.ops.importance_sampler import up_sample_round
    from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
    from neuralrecon_w_tpu_torch.ops.sdf_mlp import fused_sdf_head
    from neuralrecon_w_tpu_torch.tools.convert import init_field

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
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if args.profile:
        profile_chunk(model, fc, rcfg_warm, scene, frames[1], None, sfm_grid, "warm-up")
        profile_chunk(model, fc, rcfg_steady, scene, frames[1], fine_grid, sfm_grid, "steady")
    print(f"rays/s ({card}): warm-up {rps_warm:.1f}, steady {rps_steady:.1f}")

    if fails:
        print("FAILED: " + "; ".join(fails), file=sys.stderr)
        return 1
    sources = {"sdf_mlp": ("neuralrecon_w_tpu_torch/csrc/sdf_mlp.cu",
                           "neuralrecon_w_tpu/ops/pallas_mlp.py:130"),
               "up_sample": ("neuralrecon_w_tpu_torch/csrc/up_sample.cu",
                             "neuralrecon_w_tpu/ops/pallas_sampler.py:445")}
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
