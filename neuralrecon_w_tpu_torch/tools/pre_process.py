"""COLMAP output -> training workspace, the port's copy of
``neuralrecon_w_tpu/tools/pre_process.py`` (reference
tools/pre_process.py:1-192). Host code only: numpy, PyYAML and the
optional ``colmap`` binary.

Usage:
    python -m neuralrecon_w_tpu_torch.tools.pre_process --src <colmap dir> \\
        --dest <workspaces> [--split none|plain|"f1,f2#f3"]

It undistorts with ``colmap image_undistorter`` where that binary runs;
where it is absent or fails, it copies the sparse model and the images
as they are and says so (only PINHOLE / SIMPLE_* camera models are usable
downstream then). Then, per group of image folders, it lays out
    <dest>/<group>/dense/sparse/{cameras,images,points3D}.bin
    <dest>/<group>/dense/images/*
    <dest>/<group>/config.yaml   (origin, radius and eval_bbx from the SFM
                                  points' 4 / 96 percentiles)
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

import numpy as np
import yaml

from ..datasets.colmap import read_images_binary, read_points3d_binary, write_images_binary

UNDISTORTED = "undistorted with colmap image_undistorter"
COPIED = ("colmap binary unavailable; copying inputs as-is "
          "(only PINHOLE/SIMPLE_* models are usable downstream)")


def bbx_selection(sfm_points: np.ndarray):
    """Scene bbx and origin from the points' 4 / 96 percentiles
    (reference tools/pre_process.py:35-47)."""
    bbx = np.stack([
        np.percentile(sfm_points, q=4.0, axis=0),
        np.percentile(sfm_points, q=96.0, axis=0),
    ])
    return bbx, bbx.mean(axis=0)


def generate_config(scene_name: str, save_path: str, sfm_points: np.ndarray,
                    level: int = 5) -> dict:
    """Write ``<save_path>/config.yaml`` (reference tools/pre_process.py:135-158)."""
    bbx, origin = bbx_selection(sfm_points)
    scale = float(np.max(bbx[1] - bbx[0]) / 2)
    config = {
        "name": scene_name,
        "origin": origin.tolist(),
        "radius": scale * 2,
        "eval_bbx": bbx.tolist(),
        "sfm2gt": np.eye(4).tolist(),
        "min_track_length": 2,
        "eval_bbx_detail": bbx.tolist(),
        "voxel_size": 2 / (2**level) * scale - 0.0001,
    }
    with open(os.path.join(save_path, "config.yaml"), "w") as f:
        yaml.dump(config, f, default_flow_style=False, sort_keys=False)
    return config


def colmap_overwrite(colmap_path: str, image_folders: list) -> None:
    """Rename '<folder>/<name>' images to '<folder>_<name>'
    (reference tools/pre_process.py:49-71)."""
    image_path = os.path.join(colmap_path, "images.bin")
    images = read_images_binary(image_path)
    for key in images:
        parts = images[key].name.rsplit("/", 1)
        if len(parts) > 1 and parts[0] in image_folders:
            images[key].name = f"{parts[0]}_{parts[1]}"
    write_images_binary(images, image_path)


def undistort(src: str, colmap_dir: str, img_dir: str, out: str) -> str:
    """Run ``colmap image_undistorter`` into ``out``; where the binary is
    absent or fails, copy the inputs as they are. Prints which of the two
    ran (``UNDISTORTED`` or ``COPIED``)."""
    os.makedirs(out, exist_ok=True)
    try:
        subprocess.check_call([
            "colmap", "image_undistorter",
            "--image_path", os.path.join(src, img_dir),
            "--input_path", os.path.join(src, colmap_dir),
            "--output_path", out,
        ])
        print(UNDISTORTED)
    except (FileNotFoundError, subprocess.CalledProcessError):
        print(COPIED)
        shutil.copytree(os.path.join(src, colmap_dir),
                        os.path.join(out, "sparse"), dirs_exist_ok=True)
        shutil.copytree(os.path.join(src, img_dir),
                        os.path.join(out, "images"), dirs_exist_ok=True)
    return out


def gen_split(src: str, split: str, img_dir: str) -> list:
    """Groups of image folders: 'none' one group of the image root,
    'plain' one group per folder, else 'f1,f2#f3'."""
    if split == "none":
        return [[""]]
    if split == "plain":
        return [[g] for g in sorted(os.listdir(os.path.join(src, img_dir)))]
    return [group.split(",") for group in split.split("#")]


def convert(src: str, dest: str, split: str = "none",
            colmap_dir: str = "sparse/0", img_dir: str = "images") -> list:
    """One workspace per group; returns their paths."""
    group_list = gen_split(src, split, img_dir)
    # a hidden scratch directory: globs over <dest>/*/ see only workspaces
    undistort_path = os.path.join(dest, ".undistorted")
    undistort(src, colmap_dir, img_dir, undistort_path)

    pts3d = read_points3d_binary(os.path.join(undistort_path, "sparse", "points3D.bin"))
    sfm_points = np.array([p.xyz for p in pts3d.values() if len(p.point2D_idxs) > 2])

    scene_name = os.path.basename(os.path.normpath(src))
    out_dirs = []
    for group in group_list:
        group_name = "_".join(g for g in group if g)
        group_path = os.path.join(dest, group_name or scene_name)
        dest_sparse = os.path.join(group_path, "dense", "sparse")
        shutil.copytree(os.path.join(undistort_path, "sparse"), dest_sparse,
                        dirs_exist_ok=True)
        if group_name:
            colmap_overwrite(dest_sparse, group)
        generate_config(group_name or scene_name, group_path, sfm_points)

        dest_images = os.path.join(group_path, "dense", "images")
        os.makedirs(dest_images, exist_ok=True)
        src_img_root = os.path.join(undistort_path, "images")
        for folder in group:
            folder_path = os.path.join(src_img_root, folder) if folder else src_img_root
            for name in os.listdir(folder_path):
                full = os.path.join(folder_path, name)
                if not os.path.isfile(full):
                    continue
                new = f"{group_name}_{name}" if group_name else name
                shutil.copy(full, os.path.join(dest_images, new))
        out_dirs.append(group_path)
    shutil.rmtree(undistort_path, ignore_errors=True)
    return out_dirs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", type=str, required=True)
    parser.add_argument("--dest", type=str, required=True)
    parser.add_argument("--split", type=str, default="none",
                        help='"plain", "none", or "f1,f2#f3"')
    parser.add_argument("--colmap_dir", type=str, default="sparse/0")
    parser.add_argument("--img_dir", type=str, default="images")
    args = parser.parse_args(argv)
    out = convert(args.src, args.dest, args.split, args.colmap_dir, args.img_dir)
    print(f"workspaces: {out}")
    return out


if __name__ == "__main__":
    main()
