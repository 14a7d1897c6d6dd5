"""Ray / occupancy-grid intersection for flat grids
(``neuralrecon_w_tpu/ops/ray_voxel.py``), in plain torch.

The JAX package marches a packed occupancy bitfield with a branch-free
Amanatides-Woo DDA inside ``lax.while_loop``. Here the loop is a Python
loop over whole-batch tensor steps; it asks the device whether any ray is
still active only every ``_SYNC_EVERY`` steps, so the host does not wait
on the card at every step. The loop is bound by the host's kernel-launch
rate; a per-ray CUDA loop is the next step. Serving uses flat grids only
(``tools/render_cli.py:127``); the two-level ``HierGrid`` is not ported.

Contract (get_near_far parity): depths are ray parameters of the ENTRY
points of the first / last intersected voxel, in SFM units; rays whose
first entry is <= 1e-4 (origin inside a voxel) count as misses with
near = far = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import default_device
from .voxel_grid import VoxelGrid

_INF = 1e10
# steps between host checks of "is any ray still marching"
_SYNC_EVERY = 16


class DeviceGrid(NamedTuple):
    """Flat occupancy bitfield on the device (the level is static)."""

    occ: torch.Tensor  # (2^{3L}/32,) int32: the uint32 words, bit for bit
    origin: torch.Tensor  # (3,) float32, cube center in SFM coords
    scale: float  # cube half-extent (float32 value)
    voxel_size: float  # cell edge in SFM units (float32 value)


def device_grid_from_host(grid: VoxelGrid, device=None) -> DeviceGrid:
    """A host grid (``ops/voxel_grid.VoxelGrid``, or the JAX package's,
    which has the same fields) on ``device`` (default: the card)."""
    device = default_device(device)
    return DeviceGrid(
        occ=torch.from_numpy(grid.occupancy_words().view(np.int32)).to(device),
        origin=torch.as_tensor(np.asarray(grid.origin, np.float32), device=device),
        scale=float(np.float32(grid.scale)),
        voxel_size=float(np.float32(grid.voxel_size)),
    )


def _bit(occ: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Occupancy bit of linear cell indices (int64)."""
    word = occ[idx >> 5]
    return ((word >> (idx & 31).to(torch.int32)) & 1) == 1


def dda_traverse(occ: torch.Tensor, level: int, rays_o: torch.Tensor,
                 rays_d: torch.Tensor, first_only: bool = False,
                 max_steps: int | None = None):
    """March rays (grid-normalized coordinates) through the [-1, 1]^3
    grid. Returns (t_first, t_last, hit); misses hold 0.

    Each step is a handful of whole-batch tensor ops, so its cost is the
    host's launch rate: the cell is carried as a linear index, the grid
    exit as per-axis counts of steps left, and the step axis by argmin +
    gather / scatter. The f32 arithmetic is the JAX loop's, so the
    results are the same bit for bit."""
    n = 1 << level
    if max_steps is None:
        max_steps = 3 * n + 2
    r = rays_o.shape[0]
    cell_w = 2.0 / n

    d = torch.where(torch.abs(rays_d) < 1e-12, torch.full_like(rays_d, 1e-12), rays_d)
    inv_d = 1.0 / d
    t0 = (-1.0 - rays_o) * inv_d
    t1 = (1.0 - rays_o) * inv_d
    t_enter = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_exit = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_enter = torch.clamp(t_enter, min=0.0)
    active = t_exit > t_enter

    pos = rays_o + d * (t_enter + 1e-6)[:, None]
    cell = torch.clamp(torch.floor((pos + 1.0) / cell_w), 0, n - 1).to(torch.int64)
    up = d > 0
    next_bound = (cell + up.to(torch.int64)).float() * cell_w - 1.0
    tmax = (next_bound - rays_o) * inv_d
    tdelta = cell_w * torch.abs(inv_d)
    # a step along axis a moves the linear index by +-stride[a] and uses
    # one of the steps left before the ray leaves the grid on that axis
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
        # the index is in range while the ray is active; clamp for the rest
        occ_hit = _bit(occ, torch.clamp(idx, 0, n * n * n - 1)) & active
        first = torch.where(occ_hit & (first >= _INF), t_cur, first)
        last = torch.where(occ_hit, t_cur, last)

        axis = torch.argmin(tmax, dim=-1, keepdim=True)  # the first axis on ties
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


def occupancy_lookup(grid: DeviceGrid, level: int, pts: torch.Tensor) -> torch.Tensor:
    """Occupancy of points in grid-normalized [-1, 1]^3, any leading
    shape (flat branch of ``ray_voxel.py:298-323``)."""
    n = 1 << level
    c = torch.clamp(torch.floor((pts + 1.0) * (n / 2.0)), 0, n - 1).long()
    idx = (c[..., 0] * n + c[..., 1]) * n + c[..., 2]
    return _bit(grid.occ, idx)


def sampled_first_hit(grid: DeviceGrid, level: int, rays_o, rays_d, t_lo, t_hi,
                      n_samples: int = 1024):
    """First-hit parameter by dense occupancy sampling of [t_lo, t_hi]
    (``ray_voxel.py:326-358``). Returns (t_first, hit), t_first = 0 on miss."""
    rel = (torch.arange(n_samples, dtype=torch.float32, device=rays_o.device) + 0.5) / n_samples
    t = t_lo[:, None] + (t_hi - t_lo)[:, None] * rel[None, :]  # (R, K)
    p = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    inside = torch.amax(torch.abs(p), dim=-1) < 1.0
    occ = occupancy_lookup(grid, level, p) & inside
    hit = torch.any(occ, dim=1)
    idx = torch.argmax(occ.to(torch.uint8), dim=1)
    t_first = torch.gather(t, 1, idx[:, None])[:, 0]
    return torch.where(hit, t_first, torch.zeros_like(t_first)), hit


def grid_near_far(grid: DeviceGrid, level: int, rays_o_sfm, rays_d, first_only: bool = False):
    """near / far from voxel intersection, SFM units (far is the ENTRY of
    the last voxel: callers add voxel_size)."""
    o_norm = (rays_o_sfm - grid.origin) / grid.scale
    t_first, t_last, hit = dda_traverse(grid.occ, level, o_norm, rays_d, first_only)
    valid = hit & (t_first > 1e-4)
    zero = torch.zeros_like(t_first)
    near = torch.where(valid, t_first * grid.scale, zero)
    far = torch.where(valid, t_last * grid.scale, zero)
    return near, far, valid
