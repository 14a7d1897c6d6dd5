"""Mesh extraction CLI, on the card (``neuralrecon_w_tpu/tools/
extract_mesh_cli.py``; reference tools/extract_mesh.py:104-168,
scripts/sdf_extract.sh:13-18).

Usage:
    python -m neuralrecon_w_tpu_torch.tools.extract_mesh_cli \\
        --cfg_path config/train_X.yaml --ckpt_path results/X/checkpoints/last.ckpt \\
        --eval_level 10 --mesh_size 1024 --chunk 102144 --vertex_color

The flags and the output name are the JAX CLI's, with two differences:

  * ``--ckpt_path`` names a Lightning-layout ``.ckpt`` file
    (``training/checkpoint.py``: the reference's own checkpoints, the
    port's ``save_checkpoint``, or a JAX checkpoint exported with
    ``neuralrecon_w_tpu.tools.convert_torch_ckpt --reverse``), not an
    orbax directory;
  * ``--device`` is new, default ``cuda``: the sweeps run on that device
    (``cpu`` runs the kernels' plain versions, as the tests do).

The SDF sweep runs K1 in float32 and the vertex colours K6 in the field's
activation dtype; the mesher runs on the host. With more than one visible
card (``--device cuda``) the CLI spawns a rank per card, as the JAX CLI's
``make_mesh()`` spans every local device (``extract_mesh_cli.py:50-62``):
both sweeps split over the ranks (``parallel/mesh.py``), and rank 0
writes the ply.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple


class Extracted(NamedTuple):
    path: str  # the ply written
    grid: object  # extraction.EvalGrid
    mesh: object  # extraction.MeshData
    seconds: dict  # wall seconds per stage


def get_opts(argv=None):
    parser = argparse.ArgumentParser(description="Extract the SDF's zero isosurface as a ply.")
    parser.add_argument("--cfg_path", type=str, required=True)
    parser.add_argument("--ckpt_path", type=str, required=True,
                        help="a Lightning-layout .ckpt file")
    parser.add_argument("--mesh_size", type=int, default=1024,
                        help="dense grid dim when no eval_level given")
    parser.add_argument("--chunk", type=int, default=102144)
    parser.add_argument("--mesh_radius", type=float, default=1.0)
    parser.add_argument("--mesh_origin", type=str, default="0,0,0")
    parser.add_argument("--vertex_color", action="store_true")
    parser.add_argument("--eval_level", type=int, default=-1,
                        help=">0: sparse SFM-grid extraction at this level")
    parser.add_argument("--a_index", type=int, default=1123,
                        help="appearance embedding index for colors")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the sweeps run: cuda (the kernels) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> Extracted | None:
    """Extract and write the mesh; None when the surface is empty, or when
    the ranks of several cards ran in spawned processes."""
    args = get_opts(argv)
    import torch

    n = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
    if n <= 1:
        return extract(args)
    from ..parallel.mesh import free_coordinator, run_rank, spawn

    spawn(run_rank, n, (extract, args, n, 1, 0, free_coordinator()))
    return None


def extract(args, group=None) -> Extracted | None:
    """``main``'s work on ``args`` (parsed), as a rank of ``group`` where
    given (rank 0 writes)."""
    import numpy as np

    from ..config import field_config_from_cfg, load_cfg
    from ..datasets.colmap import read_points3d_binary
    from ..datasets.phototourism import load_scene_config
    from ..extraction import dense_eval_grid, extract_mesh, save_mesh_ply, sparse_eval_grid
    from ..parallel.mesh import is_main
    from ..training.checkpoint import load_field

    cfg = load_cfg(args.cfg_path)
    root = cfg.DATASET.ROOT_DIR
    scene_config = load_scene_config(root)
    origin = np.asarray(scene_config["origin"], np.float64)
    radius = float(scene_config["radius"])
    fc = field_config_from_cfg(cfg)
    device = args.device if group is None else group.device
    model = load_field(args.ckpt_path, fc, device).eval().requires_grad_(False)

    t0 = time.perf_counter()
    if args.eval_level > 0:
        pts3d = read_points3d_binary(os.path.join(root, "dense/sparse/points3D.bin"))
        grid = sparse_eval_grid(scene_config, pts3d, args.eval_level)
    else:
        sphere_origin = origin + np.asarray([float(v) for v in args.mesh_origin.split(",")])
        grid = dense_eval_grid(sphere_origin, radius * args.mesh_radius, args.mesh_size)
    seconds = {"grid": time.perf_counter() - t0}

    mesh = extract_mesh(model, fc, grid, origin, radius, chunk=args.chunk,
                        with_color=args.vertex_color, a_index=args.a_index,
                        device=device, timings=seconds, group=group)
    if mesh is None:
        print("empty surface; no mesh written")
        return None
    if not is_main(group):
        return None
    out = args.out or os.path.join(
        os.path.dirname(os.path.dirname(args.ckpt_path)),
        f"extracted_mesh_level_{max(args.eval_level, 0)}"
        + ("_colored" if args.vertex_color else "") + ".ply")
    t0 = time.perf_counter()
    save_mesh_ply(mesh, out)
    seconds["ply write"] = time.perf_counter() - t0
    print(f"wrote {out}: {len(mesh.verts)} verts, {len(mesh.faces)} faces from "
          f"{len(grid.points_sfm)} grid points; seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    return Extracted(out, grid, mesh, seconds)


if __name__ == "__main__":
    main()
