"""Validation and whole-image rendering (``neuralrecon_w_tpu/training/
validation.py``; reference lightning_modules/neuconw_system.py:404-546): a
held-out image rendered as a host chunk loop (without the device mesh and
the scan dispatch), its PSNR, and a GT / prediction / depth / normal PNG.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.colormap import jet_uint8


def visualize_depth(depth: np.ndarray, near_p: float = 1.0, far_p: float = 99.0):
    """Percentile-normalised jet colouring of a depth image, uint8
    (reference utils/visualization.py:13-25)."""
    d = np.asarray(depth, np.float64)
    finite = d[np.isfinite(d) & (d > 0)]
    lo, hi = np.percentile(finite, [near_p, far_p]) if finite.size else (0.0, 1.0)
    return jet_uint8(np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1))


def render_image(render_chunk, model, scene, rays: np.ndarray, ts: np.ndarray,
                 labels: np.ndarray, img_wh: tuple, chunk: int = 512,
                 fine_grid=None, sfm_grid=None, rng=None, device=None) -> dict:
    """Render (H*W) rays in chunks of ``chunk`` on ``device`` (default:
    the model's). The last chunk is padded by repeating the last ray.
    Returns (H, W, ...) numpy images: color, depth and the
    weight-averaged normal."""
    if device is None:
        device = next(model.parameters()).device
    w, h = img_wh
    n = len(rays)
    pad = (-n) % chunk
    if pad:
        rays = np.concatenate([rays, np.repeat(rays[-1:], pad, 0)], 0)
        ts = np.concatenate([ts, np.repeat(ts[-1:], pad, 0)])
        labels = np.concatenate([labels, np.repeat(labels[-1:], pad, 0)])

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, non_blocking=True)

    colors, depths, normals = [], [], []
    for i in range(0, len(rays), chunk):
        out = render_chunk(model, scene, put(rays[i:i + chunk]), put(ts[i:i + chunk]),
                           put(labels[i:i + chunk]), rng, fine_grid, sfm_grid)
        g = out["gradients"]
        wgt = out["weights"][:, : g.shape[1], None]
        colors.append(out["color"].cpu().numpy())
        depths.append(out["depth"].cpu().numpy())
        normals.append((g * wgt).sum(dim=1).cpu().numpy())
    color = np.concatenate(colors)[:n].reshape(h, w, 3)
    depth = np.concatenate(depths)[:n].reshape(h, w)
    normal = np.concatenate(normals)[:n].reshape(h, w, 3)
    return {"color": color, "depth": depth, "normal": normal}


def validation_report(render_chunk, model, scene, meta, id_: int, chunk: int = 512,
                      fine_grid=None, sfm_grid=None, out_dir: str | None = None,
                      step: int = 0) -> dict:
    """Render the validation image, its PSNR, and (with ``out_dir``) the
    PNG ``val_{step}.png``. Returns {"val/psnr": float}."""
    from ..datasets.phototourism import build_image_rays, load_image
    from .metrics import psnr

    img = load_image(meta, id_)
    h, w = img.shape[:2]
    rays, _ = build_image_rays(meta, id_, with_semantics=False)
    ts = rays[:, 8].astype(np.int32)
    labels = np.zeros((len(rays),), np.int32)
    rays10 = np.concatenate([rays[:, :8], rays[:, 9:11]], axis=1)

    out = render_image(render_chunk, model, scene, rays10, ts, labels, (w, h), chunk,
                       fine_grid, sfm_grid)
    val_psnr = float(psnr(torch.from_numpy(out["color"]), torch.from_numpy(img)))
    if out_dir is not None:
        from PIL import Image as PILImage

        os.makedirs(out_dir, exist_ok=True)
        nrm = out["normal"]
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-6)
        nrm_vis = ((nrm * 0.5 + 0.5) * 255).astype(np.uint8)
        pred_vis = (np.clip(out["color"], 0, 1) * 255).astype(np.uint8)
        gt_vis = (img * 255).astype(np.uint8)
        grid = np.concatenate(
            [np.concatenate([gt_vis, pred_vis], axis=1),
             np.concatenate([visualize_depth(out["depth"]), nrm_vis], axis=1)], axis=0)
        PILImage.fromarray(grid).save(os.path.join(out_dir, f"val_{step}.png"))
    return {"val/psnr": val_psnr}
