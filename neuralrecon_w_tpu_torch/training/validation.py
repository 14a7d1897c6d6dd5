"""Whole-image rendering as a host chunk loop
(``neuralrecon_w_tpu/training/validation.py:33-113``, without the
device mesh and the scan dispatch)."""

from __future__ import annotations

import numpy as np
import torch


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
