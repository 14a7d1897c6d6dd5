"""Ray-cache writer CLI (``neuralrecon_w_tpu/tools/prepare_data/
prepare_data_cache.py``; reference tools/prepare_data/prepare_data_cache.py:1-210
and datasets/phototourism.py:539-678).

Usage:
    python -m neuralrecon_w_tpu_torch.tools.prepare_data.prepare_data_cache \\
        --root_dir <workspace> --split_to_chunks 64 [--cache_type npz] [--device cpu]

For every training image: its rays and rgbs, the SFM keypoint depth and
weight, the semantic label column, near / far from the SFM voxel grid
(the rays that miss it dropped; the DDA runs on ``--device``, default
``cuda``), depth-supervised rays padded to the target share; then the
split cache (h5, or npz where h5py is not installed).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--img_downscale", type=int, default=1)
    parser.add_argument("--semantic_map_path", type=str, default="semantic_maps")
    parser.add_argument("--cache_dir", type=str, default="cache_sgs")
    parser.add_argument("--split_to_chunks", type=int, default=64)
    parser.add_argument("--cache_type", type=str, default="h5", choices=["h5", "npz"])
    parser.add_argument("--depth_percent", type=float, default=-1.0,
                        help="<0: the scene's default (the reference hardcodes them)")
    parser.add_argument("--no_voxel_filter", action="store_true")
    parser.add_argument("--no_semantics", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the voxel near / far DDA runs: cuda or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_opts(argv)
    from ...datasets.cache import write_ray_cache
    from ...datasets.phototourism import (SCENE_DEFAULTS, apply_voxel_near_far,
                                          build_image_rays, load_scene_meta,
                                          oversample_depth_rays)

    scene = os.path.basename(os.path.normpath(args.root_dir))
    depth_percent = (args.depth_percent if args.depth_percent >= 0
                     else SCENE_DEFAULTS.get(scene, {}).get("depth_percent", 0.0))
    meta = load_scene_meta(args.root_dir, args.img_downscale)
    if not meta.img_ids_train:
        raise SystemExit("no training images in the tsv split (all rows are 'test' or "
                         "missing from images.bin) — regenerate the split with a smaller "
                         "--num_test")

    rng = np.random.RandomState(0)
    rays_list, rgbs_list = [], []
    voxel_s = 0.0
    for id_ in meta.img_ids_train:
        rays, rgbs = build_image_rays(meta, id_, with_semantics=not args.no_semantics,
                                      semantic_map_path=args.semantic_map_path)
        if not args.no_voxel_filter:
            t0 = time.perf_counter()
            rays, rgbs = apply_voxel_near_far(rays, rgbs, meta, device=args.device)
            voxel_s += time.perf_counter() - t0
        rays, rgbs = oversample_depth_rays(rays, rgbs, depth_percent, rng)
        print(f"image {id_}: {len(rays)} rays")
        rays_list.append(rays)
        rgbs_list.append(rgbs)

    split_root = write_ray_cache(rays_list, rgbs_list, args.root_dir, args.cache_dir,
                                 args.split_to_chunks, args.img_downscale, args.cache_type)
    print(f"cache written to {split_root} (voxel near / far on {args.device}: "
          f"{voxel_s:.3f} s)")
    return split_root


if __name__ == "__main__":
    main()
