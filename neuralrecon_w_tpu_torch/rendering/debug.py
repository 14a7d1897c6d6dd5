"""Render-path debug tracing (``neuralrecon_w_tpu/rendering/debug.py``): in
place of the reference's ply dumps inside the render loop (reference
rendering/renderer.py:121-135,230-255,316-340,652-690 save_sample /
save_step_sample, tools/prepare_data/generate_voxel.py:63-68,
datasets/phototourism.py:22-27), ``trace_render`` renders a small ray
batch without jitter through ``render_rays`` and returns its
intermediates, and the ``dump_*`` writers turn them into point clouds for
any PLY viewer. Weights are coloured with the port's 'jet' table
(``utils/colormap.jet_uint8``), so no matplotlib is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import FieldConfig, RenderConfig
from ..utils.colormap import jet_uint8
from ..utils.ply import write_ply
from .renderer import SceneInfo, render_rays


def trace_render(model, fc: FieldConfig, rcfg: RenderConfig, scene: SceneInfo,
                 rays, ts, labels, rng=None, cos_anneal_ratio=1.0,
                 fine_grid=None, sfm_grid=None) -> dict:
    """Render a (small) ray batch with perturb 0 on the scene's device and
    return per-sample diagnostics as numpy: 'weights' (R, S), 'cdf' (R,
    S_fg), per-ray 'surface_points_sfm' (R, 3) at the rendered depth,
    'n_fg_samples', and the full 'render' dict (tensors)."""
    dev = scene.origin.device
    with torch.no_grad():
        out = render_rays(model, fc, rcfg, scene, torch.as_tensor(rays, device=dev),
                          torch.as_tensor(ts, device=dev), torch.as_tensor(labels, device=dev),
                          rng, cos_anneal_ratio, fine_grid=fine_grid, sfm_grid=sfm_grid,
                          perturb_overwrite=0.0)
    rays = np.asarray(torch.as_tensor(rays).cpu(), np.float32)
    origin = scene.origin.cpu().numpy()
    radius = float(scene.radius)
    o = (rays[:, 0:3] - origin) / radius
    d = rays[:, 3:6]
    depth = out["depth"].cpu().numpy()
    pts_unit = o + d * depth[:, None]
    return {
        "render": out,
        "weights": out["weights"].cpu().numpy(),
        "cdf": out["cdf_fine"].cpu().numpy(),
        "surface_points_sfm": pts_unit * radius + origin,
        "n_fg_samples": out["inside_sphere"].shape[1],
    }


def dump_weighted_points_ply(path: str, pts: np.ndarray, weights: np.ndarray,
                             wmax: float | None = None) -> None:
    """Point cloud coloured by weight, 'jet' over [0, wmax] (the reference
    colours samples by their rendering weight, renderer.py:652-690)."""
    w = np.asarray(weights, np.float64).reshape(-1)
    wmax = wmax or max(float(w.max()), 1e-8)
    write_ply(path, np.asarray(pts).reshape(-1, 3), colors=jet_uint8(np.clip(w / wmax, 0, 1)))


def dump_grid_ply(path: str, grid) -> None:
    """A VoxelGrid's cell centres (reference generate_voxel.py:63-68)."""
    write_ply(path, grid.centers_sfm())


def dump_depth_points_ply(path: str, rays: np.ndarray, depth: np.ndarray) -> None:
    """Rays' points at their depth, where it is positive (reference
    phototourism.py:584-592 vis_depth)."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    valid = depth > 0
    pts = o[valid] + d[valid] * depth[valid, None]
    write_ply(path, pts)
