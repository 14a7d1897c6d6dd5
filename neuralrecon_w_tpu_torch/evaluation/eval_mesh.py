"""Mesh against ground truth: precision / recall / F-score over thresholds
(``neuralrecon_w_tpu/evaluation/eval_mesh.py``; reference
utils/eval_mesh.py:48-123, eval_utils.py:20-123), with the same
``metrics.json`` files:
  1. the predicted mesh (ply) taken from SFM to ground-truth coordinates
     by the scene's sfm2gt,
  2. prediction and ground-truth points cropped to the bbx,
  3. the predicted mesh resampled uniformly to 10x the ground-truth count,
  4. optionally both sets cropped to the cells of the track-length /
     reprojection-error filtered SFM points,
  5. nearest-neighbour distances both ways, P / R / F per threshold,
  6. metrics.json and error-coloured point clouds per threshold.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.ply import read_ply, write_ply
from .geometry import (
    bbx_crop,
    compute_prf,
    error_colormap,
    filtered_sfm_points,
    nn_distances,
    sample_mesh_surface,
    transform_points,
    voxel_point_crop,
)


def load_eval_points(file_pred: str, file_trgt: str, scene_config: dict,
                     is_mesh: bool, bbx_name: str = "eval_bbx",
                     sample_multiplier: int = 10, seed: int = 0):
    """(verts_pred, verts_trgt) in GT coordinates, cropped to the bbx
    (reference o3d_load, eval_utils.py:20-63)."""
    bbx = scene_config[bbx_name]
    sfm2gt = np.asarray(scene_config["sfm2gt"])

    trgt = read_ply(file_trgt)
    verts_trgt = bbx_crop(np.asarray(trgt["verts"], np.float64), bbx)

    pred = read_ply(file_pred)
    verts_pred = transform_points(np.asarray(pred["verts"], np.float64), sfm2gt)
    if is_mesh and pred.get("faces") is not None and len(pred["faces"]):
        n_target = max(len(verts_trgt) * sample_multiplier, 1)
        verts_pred = sample_mesh_surface(verts_pred, pred["faces"], n_target, seed)
    verts_pred = bbx_crop(verts_pred, bbx)
    return verts_pred, verts_trgt


def eval_mesh(
    file_pred: str,
    file_trgt: str,
    scene_config: dict,
    is_mesh: bool = True,
    threshold=0.1,
    bbx_name: str = "eval_bbx",
    save_name: str = "eval",
    save_dir: str | None = None,
    write_visualizations: bool = True,
) -> dict:
    """Returns {"thresholds", "fscores", "precs", "recals"} and writes
    metrics.json (+ per-threshold error plys) next to the prediction
    (reference eval_mesh, utils/eval_mesh.py:48-123)."""
    if save_dir is None:
        save_dir = os.path.join(os.path.dirname(file_pred), f"eval_{save_name}")
    os.makedirs(save_dir, exist_ok=True)

    verts_pred, verts_trgt = load_eval_points(
        file_pred, file_trgt, scene_config, is_mesh, bbx_name
    )

    if "sfm_path" in scene_config:
        from ..datasets.colmap import read_points3d_binary

        pts3d = read_points3d_binary(
            os.path.join(scene_config["sfm_path"], "points3D.bin")
        )
        sfm_filtered = filtered_sfm_points(
            pts3d, np.asarray(scene_config["sfm2gt"]),
            scene_config["eval_tl"], scene_config["eval_error"],
        )
        if write_visualizations:
            write_ply(os.path.join(save_dir, "sfm_points.ply"), sfm_filtered)
        voxel = scene_config["eval_voxel"]
        bbx = scene_config[bbx_name]
        verts_pred = voxel_point_crop(verts_pred, sfm_filtered, voxel, bbx)
        verts_trgt = voxel_point_crop(verts_trgt, sfm_filtered, voxel, bbx)

    if len(verts_pred) == 0 or len(verts_trgt) == 0:
        print(
            f"eval_mesh: empty point set after cropping "
            f"(pred={len(verts_pred)}, gt={len(verts_trgt)}) — the "
            f"prediction lies outside {bbx_name}; scoring as zero overlap"
        )

    # dist1: gt -> pred (recall); dist2: pred -> gt (precision)
    _, dist1 = nn_distances(verts_trgt, verts_pred)
    _, dist2 = nn_distances(verts_pred, verts_trgt)

    thresholds = threshold if isinstance(threshold, (list, tuple)) else [threshold]
    fscores, precs, recals = [], [], []
    for th in thresholds:
        m = compute_prf(dist1, dist2, th)
        tdir = os.path.join(save_dir, "visualize", f"{th:.2f}")
        os.makedirs(tdir, exist_ok=True)
        with open(os.path.join(tdir, "metrics.json"), "w") as f:
            json.dump(m, f)
        if write_visualizations and len(verts_pred) and len(verts_trgt):
            write_ply(os.path.join(tdir, "error_pred_precision.ply"),
                      verts_pred, colors=error_colormap(dist2, th))
            write_ply(os.path.join(tdir, "error_gt_recal.ply"),
                      verts_trgt, colors=error_colormap(dist1, th))
        fscores.append(m["fscore"])
        precs.append(m["prec"])
        recals.append(m["recal"])

    all_metrics = {
        "thresholds": list(thresholds),
        "fscores": fscores,
        "precs": precs,
        "recals": recals,
        # threshold-free accuracy/completeness means (the reference
        # records these per-threshold as dist1/dist2, eval_utils.py:87-100)
        "chamfer_pred_to_gt": float(np.mean(dist2)) if len(dist2) else float("inf"),
        "chamfer_gt_to_pred": float(np.mean(dist1)) if len(dist1) else float("inf"),
    }
    with open(os.path.join(save_dir, "metrics.json"), "w") as f:
        json.dump(all_metrics, f)
    return all_metrics


def eval_mesh_arrays(verts_pred: np.ndarray, verts_trgt: np.ndarray,
                     threshold=0.1) -> dict:
    """In-memory variant used by inline validation
    (reference lightning_modules/neuconw_system.py:515-531)."""
    _, dist1 = nn_distances(verts_trgt, verts_pred)
    _, dist2 = nn_distances(verts_pred, verts_trgt)
    return compute_prf(dist1, dist2, threshold)
