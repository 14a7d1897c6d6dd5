"""Geometry for mesh evaluation, numpy and scipy
(``neuralrecon_w_tpu/evaluation/geometry.py``; reference utils/eval_utils.py:20-216):
the bounding-box crop, area-weighted surface sampling, nearest-neighbour
distances both ways (a cKDTree query), precision / recall / F-score, the
SFM track-length / reprojection-error filter and the Morton-code voxel crop.
"""

from __future__ import annotations

import numpy as np

from ..ops.voxel_grid import _linear
from ..utils.colormap import jet_uint8


def transform_points(points: np.ndarray, mat4: np.ndarray) -> np.ndarray:
    """A 4x4 (or 3x4) homogeneous transform applied to (N, 3) points."""
    m = np.asarray(mat4)
    return points @ m[:3, :3].T + m[:3, 3]


def bbx_crop(points: np.ndarray, bbx) -> np.ndarray:
    """The points strictly inside the open box (reference
    eval_utils.py:103-114)."""
    bbx_min = np.asarray(bbx[0], np.float64)
    bbx_max = np.asarray(bbx[1], np.float64)
    origin = bbx_min + (bbx_max - bbx_min) / 2
    scale = (bbx_max - bbx_min) / 2
    n = (points - origin) / scale
    return points[np.all(n > -1, axis=-1) & np.all(n < 1, axis=-1)]


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray, n_points: int,
                        seed: int = 0) -> np.ndarray:
    """Uniform area-weighted surface samples (open3d
    sample_points_uniformly, reference eval_utils.py:43)."""
    if len(faces) == 0 or n_points <= 0:
        return verts[:0]
    rs = np.random.RandomState(seed)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    total = area.sum()
    if total <= 0:
        return verts[:0]
    fi = rs.choice(len(faces), n_points, p=area / total)
    r1 = np.sqrt(rs.rand(n_points, 1))
    r2 = rs.rand(n_points, 1)
    return v0[fi] * (1 - r1) + v1[fi] * r1 * (1 - r2) + v2[fi] * r1 * r2


def nn_distances(query: np.ndarray, target: np.ndarray):
    """(indices, distances) of each query point's nearest target point
    (reference nn_correspondance, eval_utils.py:126-154)."""
    if len(query) == 0 or len(target) == 0:
        return np.zeros(0, np.int64), np.zeros(0)
    from scipy.spatial import cKDTree

    dist, idx = cKDTree(np.asarray(target)).query(np.asarray(query), k=1, workers=-1)
    return idx, dist


def compute_prf(dist_gt_to_pred: np.ndarray, dist_pred_to_gt: np.ndarray,
                threshold: float) -> dict:
    """Precision / recall / F-score and the chamfer means at one threshold
    (reference _compute, eval_utils.py:87-100). An empty side scores zero
    matches and an infinite chamfer, never NaN."""

    def _frac_below(d):
        return float(np.mean(d < threshold)) if len(d) else 0.0

    def _mean(d):
        return float(np.mean(d)) if len(d) else float("inf")

    precision = max(_frac_below(dist_pred_to_gt), 1e-6)
    recall = max(_frac_below(dist_gt_to_pred), 1e-6)
    return {
        "dist1": _mean(dist_pred_to_gt),
        "dist2": _mean(dist_gt_to_pred),
        "prec": precision,
        "recal": recall,
        "fscore": 2 * precision * recall / (precision + recall),
    }


def filtered_sfm_points(points3d: dict, sfm_to_gt: np.ndarray, track_length: int,
                        reproj_error: float) -> np.ndarray:
    """The SFM points past the track-length and error thresholds, in
    ground-truth coordinates (reference filtered_sfm, eval_utils.py:157-177)."""
    pts = [p.xyz for p in points3d.values()
           if len(p.point2D_idxs) > track_length and p.error < reproj_error]
    if not pts:
        return np.zeros((0, 3))
    return transform_points(np.vstack(pts), np.asarray(sfm_to_gt))


def voxel_point_crop(src_pts: np.ndarray, voxel_pts: np.ndarray, voxel_size: float,
                     bbx) -> np.ndarray:
    """The src points in cells that voxel_pts occupy (reference point_crop,
    eval_utils.py:180-216): both sets quantised at floor(2 * scale /
    voxel_size) over the bbx cube and matched by cell index."""
    bbx_min = np.asarray(bbx[0], np.float64)
    bbx_max = np.asarray(bbx[1], np.float64)
    origin = bbx_min + (bbx_max - bbx_min) / 2
    scale = np.max(bbx_max - bbx_min) / 2
    res = int(np.floor(2 * scale / voxel_size))

    def quantize(p):
        return np.floor(res * ((p - origin) / scale + 1.0) / 2.0).astype(np.int64)

    src_c = _linear(np.clip(quantize(src_pts), 0, (1 << 21) - 1), 21)
    vox_c = np.unique(_linear(np.clip(quantize(voxel_pts), 0, (1 << 21) - 1), 21))
    return src_pts[np.isin(src_c, vox_c)]


def error_colormap(dists: np.ndarray, threshold: float) -> np.ndarray:
    """Jet colours of per-point errors, saturating at 3 * threshold
    (reference visualize_error, eval_utils.py:116-123), uint8."""
    return jet_uint8(np.minimum(dists, threshold * 3) / (threshold * 3))
