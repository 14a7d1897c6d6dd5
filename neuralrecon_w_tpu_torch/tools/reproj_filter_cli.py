"""Reprojection filter CLI (``neuralrecon_w_tpu/tools/reproj_filter_cli.py``;
reference utils/reproj_filter.py:246-300): render the reconstruction from
every training camera of a workspace and keep the geometry that at least
one view observes; writes ``<out_dir>/reprojected.ply``.

Usage:
    python -m neuralrecon_w_tpu_torch.tools.reproj_filter_cli \\
        --src_file mesh.ply --root_dir <COLMAP workspace> [--img_downscale 4] \\
        [--voxel_size V] [--out_dir D] [--workers N] [--device cpu]

A ply with faces runs mesh mode (the host rasteriser); one without runs
point-cloud mode, whose DDA runs on the card unless ``--device cpu``. It
prints the kept count and one line ``stages {...}`` of each stage's seconds
(``evaluation/reproj_filter.reprojection_filter``'s ``stats``).
"""

from __future__ import annotations

import argparse
import json
import os


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src_file", type=str, required=True,
                        help="ply to filter (mesh or point cloud)")
    parser.add_argument("--root_dir", type=str, required=True,
                        help="COLMAP workspace (for the training cameras)")
    parser.add_argument("--img_downscale", type=int, default=4,
                        help="render resolution divisor")
    parser.add_argument("--voxel_size", type=float, default=None,
                        help="match voxel size; default: the scene config's voxel_size")
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--workers", type=int, default=0,
                        help="views on a thread pool (mesh mode)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the point-cloud DDA runs: cuda (K10 / K12) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_opts(argv)

    from ..datasets.phototourism import load_scene_meta
    from ..evaluation import reprojection_filter
    from ..utils.ply import read_ply, write_ply

    meta = load_scene_meta(args.root_dir, args.img_downscale)
    cameras = []
    for id_ in meta.img_ids_train:
        K = meta.Ks[id_]
        cameras.append((K, meta.poses[id_], (int(K[0, 2] * 2), int(K[1, 2] * 2))))

    voxel = args.voxel_size or float(meta.scene_config["voxel_size"])
    data = read_ply(args.src_file)
    stats = {}
    kept_verts, kept_faces, mask = reprojection_filter(
        data["verts"], data.get("faces"), cameras, voxel, workers=args.workers,
        device=args.device, stats=stats)
    out_dir = args.out_dir or os.path.dirname(args.src_file)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "reprojected.ply")
    colors = data.get("colors")
    write_ply(out, kept_verts, faces=kept_faces,
              colors=colors[mask] if colors is not None else None)
    print(f"kept {mask.sum()}/{len(mask)} vertices -> {out}")
    print("stages " + json.dumps(stats))
    return out


if __name__ == "__main__":
    main()
