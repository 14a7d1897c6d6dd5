"""Camera rays for one image, on the host in numpy
(``neuralrecon_w_tpu/datasets/rays.py``).

The reference's conventions (reference datasets/ray_utils.py:5-52): no
+0.5 pixel centring, an OpenGL-style camera (x right, y up, z backward),
unit-norm world directions, origins broadcast from the camera centre.
"""

from __future__ import annotations

import numpy as np


def get_ray_directions(H: int, W: int, K: np.ndarray) -> np.ndarray:
    """Per-pixel ray directions in camera coordinates, (H, W, 3)."""
    j, i = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                       indexing="ij")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    return np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], axis=-1)


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """World-space rays of one image from its (H, W, 3) camera directions
    and (3, 4) camera-to-world matrix: (rays_o, rays_d), both (H*W, 3),
    rays_d unit-norm."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return rays_o.reshape(-1, 3).copy(), rays_d.reshape(-1, 3)


def get_ndc_rays(H, W, focal, near, rays_o, rays_d):
    """Rays in NDC space (reference datasets/ray_utils.py:55-96); the
    phototourism pipeline does not use them."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2

    return np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)
