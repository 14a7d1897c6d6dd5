"""Ray queries of a flat occupancy grid: the exact Amanatides-Woo DDA and
the sampled first hit, in grid-normalised coordinates, and the near / far
of a grid in SFM units. Copied from the port's plain versions
(``ops/ray_voxel.py``: ``dda_traverse_plain``, ``sampled_first_hit_plain``,
``grid_near_far``), which its kernels K10 / K11 equal bit for bit; a grid is
(occ words, origin, scale, voxel_size, level), bit (x N + y) N + z."""

from __future__ import annotations

import torch

_INF = 1e10
_SYNC_EVERY = 16


def bit(occ: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return ((occ[idx >> 5] >> (idx & 31).to(torch.int32)) & 1) == 1


def dda(occ, level: int, rays_o, rays_d, first_only: bool = False):
    """(t_first, t_last, hit) of rays (R, 3) marched through [-1, 1]^3;
    misses hold 0."""
    n = 1 << level
    max_steps = 3 * n + 2
    r = rays_o.shape[0]
    cell_w = 2.0 / n
    d = torch.where(torch.abs(rays_d) < 1e-12, torch.full_like(rays_d, 1e-12), rays_d)
    inv_d = 1.0 / d
    t0 = (-1.0 - rays_o) * inv_d
    t1 = (1.0 - rays_o) * inv_d
    t_enter = torch.clamp(torch.amax(torch.minimum(t0, t1), dim=-1), min=0.0)
    t_exit = torch.amin(torch.maximum(t0, t1), dim=-1)
    active = t_exit > t_enter
    pos = rays_o + d * (t_enter + 1e-6)[:, None]
    cell = torch.clamp(torch.floor((pos + 1.0) / cell_w), 0, n - 1).to(torch.int64)
    up = d > 0
    tmax = ((cell + up.to(torch.int64)).float() * cell_w - 1.0 - rays_o) * inv_d
    tdelta = cell_w * torch.abs(inv_d)
    stride = torch.tensor([n * n, n, 1], dtype=torch.int64, device=rays_o.device)
    idx_step = torch.where(up, stride, -stride)
    left = torch.where(up, n - 1 - cell, cell)
    idx = (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2]
    minus_one = torch.full((r, 1), -1, dtype=torch.int64, device=rays_o.device)
    t_cur = t_enter
    first = torch.full((r,), _INF, device=rays_o.device)
    last = torch.full((r,), -_INF, device=rays_o.device)
    for i in range(max_steps):
        if i % _SYNC_EVERY == 0 and not bool(active.any()):
            break
        occ_hit = bit(occ, torch.clamp(idx, 0, n * n * n - 1)) & active
        first = torch.where(occ_hit & (first >= _INF), t_cur, first)
        last = torch.where(occ_hit, t_cur, last)
        axis = torch.argmin(tmax, dim=-1, keepdim=True)
        t_next = torch.gather(tmax, 1, axis)[:, 0]
        tmax = tmax.scatter_add(1, axis, torch.gather(tdelta, 1, axis))
        idx = idx + torch.gather(idx_step, 1, axis)[:, 0]
        left = left.scatter_add(1, axis, minus_one)
        active = active & (torch.gather(left, 1, axis)[:, 0] >= 0) & (t_next <= t_exit)
        if first_only:
            active = active & (first >= _INF)
        t_cur = t_next
    hit = first < _INF
    zero = torch.zeros_like(first)
    return torch.where(hit, first, zero), torch.where(hit, last, zero), hit


def near_far(grid, rays_o_sfm, rays_d, first_only: bool = False):
    """(near, far, valid) in SFM units: the entries of the first and last
    occupied cells (far is an entry: callers add voxel_size); an origin
    inside a cell (first entry <= 1e-4) counts as a miss."""
    o = (rays_o_sfm - grid.origin) / grid.scale
    t_first, t_last, hit = dda(grid.occ, grid.level, o, rays_d, first_only)
    valid = hit & (t_first > 1e-4)
    zero = torch.zeros_like(t_first)
    return (torch.where(valid, t_first * grid.scale, zero),
            torch.where(valid, t_last * grid.scale, zero), valid)


def sampled_first_hit(grid, rays_o, rays_d, t_lo, t_hi, n_samples: int):
    """(t_first, hit): the first of n_samples midpoints of [t_lo, t_hi]
    inside the cube and occupied; rays in grid-normalised coordinates."""
    n = 1 << grid.level
    rel = (torch.arange(n_samples, dtype=torch.float32, device=rays_o.device) + 0.5) / n_samples
    t = t_lo[:, None] + (t_hi - t_lo)[:, None] * rel[None, :]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    inside = torch.amax(torch.abs(pts), dim=-1) < 1.0
    c = torch.clamp(torch.floor((pts + 1.0) * (n / 2.0)), 0, n - 1).long()
    occ = bit(grid.occ, (c[..., 0] * n + c[..., 1]) * n + c[..., 2]) & inside
    hit = torch.any(occ, dim=1)
    first = torch.gather(t, 1, torch.argmax(occ.to(torch.uint8), dim=1)[:, None])[:, 0]
    return torch.where(hit, first, torch.zeros_like(first)), hit
