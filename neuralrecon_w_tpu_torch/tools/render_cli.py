"""Novel-view rendering CLI, on the card (``neuralrecon_w_tpu/tools/
render_cli.py``): images from a trained checkpoint.

- render dataset views from a checkpoint (colour, depth, normal PNGs),
- override the per-image appearance embedding (``--a_index``),
- interpolate appearance between two images' embeddings (NeRF-W's
  appearance interpolation, Martin-Brualla et al.), optionally moving the
  camera from one view to the other (``--pose_interp``, slerped rotation)
  and writing a ping-pong GIF (``--gif``).

Usage:
    python -m neuralrecon_w_tpu_torch.tools.render_cli \\
        --cfg_path config/train_brandenburg_gate.yaml \\
        --ckpt_path results/bg/checkpoints/step_100000.ckpt \\
        --img_ids 10,42 --out_dir renders/ [--device cpu]

    python -m neuralrecon_w_tpu_torch.tools.render_cli --cfg_path ... --ckpt_path ... \\
        --a_interp 10,42 --frames 12 --pose_interp --gif --out_dir renders/

``--ckpt_path`` is a Lightning-layout ``.ckpt`` (``training/checkpoint.py``);
the fine grid the trainer saved in it drives surface-guided sampling.
``--dispatch scan`` (the default) renders a frame as one call of
``training/step.make_scan_render_fn``: on the card, one chunk of ``--chunk``
rays captured in a CUDA graph and replayed for every chunk, the frame
fetched once, in every SDF_GRAD_MODE and with either background.
``--dispatch chunk`` renders a host loop of ``training/step.make_render_fn``
calls. With more than one visible card (``--device cuda``) the CLI
spawns a rank per card, as the JAX CLI's mesh spans every local device
(``render_cli.py:155-157``): each chunk is split over the ranks (the scan
dispatch is then not used; ``--chunk`` must divide over them), and rank 0
writes the images.
"""

from __future__ import annotations

import argparse
import os


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", type=str, required=True)
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--out_dir", type=str, default="renders")
    parser.add_argument("--img_ids", type=str, default="",
                        help="comma list of dataset image ids; default: the first train image")
    parser.add_argument("--img_downscale", type=int, default=-1,
                        help="render resolution divisor; default max(8, DATASET downscale) "
                        "like validation")
    parser.add_argument("--chunk", type=int, default=512,
                        help="rays per render call (--test_batch_size)")
    parser.add_argument("--a_index", type=int, default=-1,
                        help=">=0: render every view under this one appearance embedding")
    parser.add_argument("--a_interp", type=str, default="",
                        help="'I,J': interpolate appearance embeddings between images I and J "
                        "over --frames")
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--pose_interp", action="store_true",
                        help="with --a_interp: also move the camera from view I to view J")
    parser.add_argument("--gif", action="store_true",
                        help="with --a_interp: also write an animated GIF (ping-pong loop)")
    parser.add_argument("--gif_ms", type=int, default=120, help="GIF frame duration, ms")
    parser.add_argument("--dispatch", choices=["scan", "chunk"], default="scan",
                        help="'scan' renders a frame as replays of one captured chunk on the "
                        "card (the serving path); 'chunk' as a host loop of chunk calls")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the render runs: cuda (the kernels) or cpu")
    return parser.parse_args(argv)


def _slerp_pose(p0, p1, t):
    """Two (3, 4) c2w poses interpolated: slerped rotation, lerped centre."""
    import numpy as np
    from scipy.spatial.transform import Rotation, Slerp

    rots = Rotation.from_matrix(np.stack([p0[:, :3], p1[:, :3]]))
    r = Slerp([0.0, 1.0], rots)(t).as_matrix()
    c = (1.0 - t) * p0[:, 3] + t * p1[:, 3]
    return np.concatenate([r, c[:, None]], axis=1).astype(np.float32)


def _rays_for_pose(K, c2w, wh, near, far):
    """(N, 10) render-layout rays [o, d, near, far, depth=0, weight=0] of
    any camera."""
    import numpy as np

    from ..datasets.rays import get_ray_directions, get_rays

    w, h = wh
    rays_o, rays_d = get_rays(get_ray_directions(h, w, K), c2w)
    n = len(rays_o)
    return np.concatenate([rays_o.astype(np.float32), rays_d.astype(np.float32),
                           np.full((n, 1), near, np.float32), np.full((n, 1), far, np.float32),
                           np.zeros((n, 2), np.float32)], axis=1)


def _save_frame(out_dir, name, out):
    import numpy as np
    from PIL import Image as PILImage

    from ..training.validation import visualize_depth

    os.makedirs(out_dir, exist_ok=True)
    color = (np.clip(out["color"], 0, 1) * 255).astype(np.uint8)
    PILImage.fromarray(color).save(os.path.join(out_dir, f"{name}.png"))
    PILImage.fromarray(visualize_depth(out["depth"])).save(
        os.path.join(out_dir, f"{name}_depth.png"))
    nrm = out["normal"]
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-6)
    PILImage.fromarray(((nrm * 0.5 + 0.5) * 255).astype(np.uint8)).save(
        os.path.join(out_dir, f"{name}_normal.png"))


def main(argv=None):
    args = get_opts(argv)
    import torch

    n = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
    if n <= 1:
        return render(args)
    from ..parallel.mesh import free_coordinator, run_rank, spawn

    spawn(run_rank, n, (render, args, n, 1, 0, free_coordinator()))


def render(args, group=None):
    """``main``'s work on ``args`` (parsed), as a rank of ``group`` where
    given (rank 0 writes)."""
    import numpy as np
    import torch

    from ..config import field_config_from_cfg, load_cfg, render_config_from_cfg
    from ..datasets.phototourism import build_image_rays, load_image
    from ..models.neuconw import NeuconWField
    from ..ops.ray_voxel import device_grid_from_host
    from ..parallel.mesh import is_main
    from ..training.checkpoint import restore_checkpoint, restore_field_
    from ..training.step import make_render_fn, make_scan_render_fn
    from ..training.validation import render_image
    from ..utils.scene import load_scene_bundle, val_downscale

    device = torch.device(args.device) if group is None else group.device
    main_rank = is_main(group)
    cfg = load_cfg(args.cfg_path)
    ds = args.img_downscale if args.img_downscale > 0 else val_downscale(cfg)
    meta, scene, sfm_grid, sfm_dgrid = load_scene_bundle(cfg, ds, device)

    fc = field_config_from_cfg(cfg)
    restored = restore_checkpoint(args.ckpt_path)
    model = restore_field_(NeuconWField(fc, device), restored).eval().requires_grad_(False)
    fine_dgrid, fine_level = None, -1
    if "fine_grid" in restored:
        fine_dgrid = device_grid_from_host(restored["fine_grid"], device)
        fine_level = restored["fine_grid"].level

    rcfg = render_config_from_cfg(cfg, sfm_level=sfm_grid.level, fine_level=fine_level,
                                  nerf_far_override=bool(cfg.NEUCONW.NEAR_FAR_OVERRIDE))
    render_chunk = make_render_fn(fc, rcfg)
    scan_render = (make_scan_render_fn(fc, rcfg, args.chunk) if args.dispatch == "scan"
                   else None)

    def render_view(rays10, ts, wh, name):
        labels = np.zeros((len(rays10),), np.int32)
        out = render_image(render_chunk, model, scene, rays10, ts, labels, wh, args.chunk,
                           fine_dgrid, sfm_dgrid, scan_render=scan_render, group=group)
        if main_rank:
            _save_frame(args.out_dir, name, out)
            print(f"wrote {args.out_dir}/{name}.png ({wh[0]}x{wh[1]})")
        return out

    table = model.embedding_a.weight
    if args.a_interp:
        i, j = (int(x) for x in args.a_interp.split(","))
        for idx in (i, j):
            if not (0 <= idx < table.shape[0]) or idx not in meta.poses:
                raise SystemExit(f"--a_interp index {idx} is not a dataset image id within "
                                 f"N_VOCAB {table.shape[0]}; choose ids from the scene tsv")
        e_i, e_j = table[i].detach().clone(), table[j].detach().clone()
        row0 = table[0].detach().clone()
        # base camera: view i, or the interpolated one with --pose_interp
        K = meta.Ks[i]
        h, w = load_image(meta, i).shape[:2]
        if not args.pose_interp:
            rays_i, _ = build_image_rays(meta, i, with_semantics=False)
        near = float(min(meta.nears[i], meta.nears[j]))
        far = float(max(meta.fars[i], meta.fars[j]))
        try:
            for k in range(args.frames):
                t = k / max(args.frames - 1, 1)
                with torch.no_grad():
                    table[0].copy_((1.0 - t) * e_i + t * e_j)
                if args.pose_interp:
                    c2w = _slerp_pose(np.asarray(meta.poses[i], np.float64),
                                      np.asarray(meta.poses[j], np.float64), t)
                    rays10 = _rays_for_pose(K, c2w, (w, h), near, far)
                else:
                    rays10 = np.concatenate([rays_i[:, :8], rays_i[:, 9:11]], axis=1)
                render_view(rays10, np.zeros((len(rays10),), np.int32), (w, h),
                            f"interp_{i}_{j}_{k:03d}")
        finally:
            with torch.no_grad():
                table[0].copy_(row0)
        if args.gif and main_rank:
            from PIL import Image as PILImage

            frames = [PILImage.open(os.path.join(args.out_dir, f"interp_{i}_{j}_{k:03d}.png"))
                      .convert("P") for k in range(args.frames)]
            seq = frames + frames[-2:0:-1]  # ping-pong loop
            gif_path = os.path.join(args.out_dir, f"interp_{i}_{j}.gif")
            seq[0].save(gif_path, save_all=True, append_images=seq[1:], duration=args.gif_ms,
                        loop=0)
            print(f"wrote {gif_path} ({len(seq)} frames)")
        return

    ids = ([int(x) for x in args.img_ids.split(",")] if args.img_ids
           else [meta.img_ids_train[0]])
    a_index = args.a_index
    if a_index >= fc.n_vocab:
        print(f"# appearance index {a_index} >= N_VOCAB {fc.n_vocab}; clamping")
        a_index = fc.n_vocab - 1
    for id_ in ids:
        h, w = load_image(meta, id_).shape[:2]
        rays, _ = build_image_rays(meta, id_, with_semantics=False)
        rays10 = np.concatenate([rays[:, :8], rays[:, 9:11]], axis=1)
        ts = (np.full((len(rays10),), a_index, np.int32) if a_index >= 0
              else rays[:, 8].astype(np.int32))
        render_view(rays10, ts, (w, h), f"view_{id_}")


if __name__ == "__main__":
    main()
