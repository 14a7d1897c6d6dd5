"""Reprojection error of the SFM tracks against the ground-truth scan
(``neuralrecon_w_tpu/tools/reproj_error.py``; reference
tools/reproj_error.py:1-277).

For each COLMAP track longer than ``--track_length``: the GT surface point
nearest its SFM point (a KD-tree in SFM coordinates), projected into every
view that observes the track, against the observed keypoint; the pixel
errors' statistics say how well the SFM registration matches the scan.

Usage:
    python -m neuralrecon_w_tpu_torch.tools.reproj_error --root_dir <workspace> \\
        --gt_ply gt.ply [--track_length 5] [--out err.json]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..datasets.colmap import read_cameras_binary, read_images_binary, read_points3d_binary
from ..datasets.phototourism import intrinsics_from_camera
from ..utils.ply import read_ply


def project(K: np.ndarray, w2c: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(N, 3) world points -> (N, 2) pixels (COLMAP's w2c convention)."""
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    uv = cam @ K.T
    return uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)


def gt_reproject_error(root_dir: str, gt_ply: str, sfm2gt: np.ndarray, track_length: int = 5,
                       max_points: int = 20000) -> dict:
    """Mean, median and 90th-percentile pixel error of the GT-snapped track
    points over their observations (reference gt_reproject_error,
    tools/reproj_error.py:143-247)."""
    from scipy.spatial import cKDTree

    sparse = os.path.join(root_dir, "dense/sparse")
    imdata = read_images_binary(os.path.join(sparse, "images.bin"))
    camdata = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    pts3d = read_points3d_binary(os.path.join(sparse, "points3D.bin"))

    gt2sfm = np.linalg.inv(np.asarray(sfm2gt))
    gt_in_sfm = read_ply(gt_ply)["verts"] @ gt2sfm[:3, :3].T + gt2sfm[:3, 3]
    tree = cKDTree(gt_in_sfm)

    tracks = [p for p in pts3d.values() if len(p.point2D_idxs) > track_length][:max_points]
    xyz = np.array([p.xyz for p in tracks]).reshape(-1, 3)
    _, nn = tree.query(xyz, k=1, workers=-1)
    snapped = gt_in_sfm[nn]

    w2c_by_img, K_by_img = {}, {}
    for im in imdata.values():
        w2c_by_img[im.id] = np.concatenate([im.qvec2rotmat(), im.tvec.reshape(3, 1)], 1)
        K_by_img[im.id] = intrinsics_from_camera(camdata[im.camera_id], 1)

    errors = []
    for p, snap in zip(tracks, snapped):
        for img_id, p2d_idx in zip(p.image_ids, p.point2D_idxs):
            if img_id not in w2c_by_img:
                continue
            obs = imdata[img_id].xys[p2d_idx]
            proj = project(K_by_img[img_id], w2c_by_img[img_id], snap[None])[0]
            errors.append(np.linalg.norm(proj - obs))
    errors = np.asarray(errors)
    if not len(errors):
        return {"n_observations": 0, "mean_px": 0.0, "median_px": 0.0, "p90_px": 0.0}
    return {"n_observations": int(len(errors)), "mean_px": float(errors.mean()),
            "median_px": float(np.median(errors)), "p90_px": float(np.percentile(errors, 90))}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--gt_ply", type=str, required=True)
    parser.add_argument("--track_length", type=int, default=5)
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)

    import yaml

    with open(os.path.join(args.root_dir, "config.yaml")) as f:
        sfm2gt = np.asarray(yaml.safe_load(f)["sfm2gt"])
    res = gt_reproject_error(args.root_dir, args.gt_ply, sfm2gt, args.track_length)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
