"""The online surface-grid refresh, "octree_update"
(``neuralrecon_w_tpu/training/surface.py``).

Every UPDATE_FREQ steps the SFM grid is densified to the training level,
the SDF is swept at every cell centre, the cells with sdf <= SDF_THRESHOLD
are kept, and the fine grid built from them recentres the next steps' ray
sampling on the current zero set (reference
lightning_modules/neuconw_system.py:186-312). The sweep is
``parallel/sweep.sharded_sdf_sweep``: K1 in float32 on the card (its plain
version for a model on the CPU); with a data group it is split over the
ranks and gathered, so every rank builds the same grid
(``surface.py:55``, the JAX package's sweep over its mesh). The
densified cells, their centres and the rebuilt grid's packed bitfield are
made on the model's device (the host arrays' float64 arithmetic, so the
same cells bit for bit); the host gets the sweep's points and the kept
cells.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..ops.ray_voxel import DeviceGrid, device_grid_from_host
from ..ops.voxel_grid import VoxelGrid, level_for_voxel_size, scene_bbx_sfm
from ..parallel.sweep import sharded_sdf_sweep


def surface_level(scene_config: dict, train_voxel_size: float) -> int:
    """The level whose cells are <= train_voxel_size over the scene cube
    (reference neuconw_system.py:314-335 rounds up)."""
    bbx_min, bbx_max = scene_bbx_sfm(scene_config, in_sfm=True)
    scale = float(np.max(bbx_max - bbx_min) / 2.0)
    return level_for_voxel_size(scale, train_voxel_size, mode="ceil")


def _dense_cells(sfm_grid: VoxelGrid, level: int, device) -> torch.Tensor:
    """``sfm_grid.upsample(level)``'s cells as their sorted linear indices
    ((x * N + y) * N + z, N = 2^level), int64 on ``device``: a cell's
    children are its corner child's index plus a fixed offset each."""
    up = level - sfm_grid.level
    if up < 0:
        raise ValueError(f"cannot upsample level {sfm_grid.level} to {level}")
    t, n = 1 << up, 1 << level
    k = torch.arange(t, device=device)
    offsets = ((k[:, None, None] * n + k[None, :, None]) * n + k[None, None, :]).reshape(-1)
    c = torch.from_numpy(np.asarray(sfm_grid.coords, np.int64)).to(device) * t
    corner = (c[:, 0] * n + c[:, 1]) * n + c[:, 2]
    return torch.sort((corner[:, None] + offsets).reshape(-1)).values


def _cell_xyz(lin: torch.Tensor, level: int) -> torch.Tensor:
    n = 1 << level
    return torch.stack([lin // (n * n), (lin // n) % n, lin % n], dim=1)


def _swept_candidates(model, fc, sfm_grid: VoxelGrid, train_level: int,
                      scene_origin: np.ndarray, scene_radius: float, sdf_threshold: float = 0.0,
                      chunk: int = 65536, stats_out: dict | None = None, group=None):
    """The SFM grid densified to ``train_level`` on the model's device: its
    cells' sorted linear indices, their centres in SFM and unit-sphere
    coordinates (float64, ``VoxelGrid.centers_sfm``'s arithmetic), and
    which of them the SDF keeps (sdf <= the threshold, a host bool array;
    reference neuconw_system.py:186-266). ``stats_out``, when given, gets
    n_candidates / n_kept / kept_frac and the sweep's wall seconds
    (sweep_seconds); a keep above 90 % warns."""
    device = next(model.parameters()).device
    lin = _dense_cells(sfm_grid, train_level, device)
    f64 = dict(dtype=torch.float64, device=device)
    centers_sfm = (((_cell_xyz(lin, train_level).double() + 0.5) / (1 << train_level) * 2.0
                    - 1.0) * float(sfm_grid.scale) + torch.as_tensor(sfm_grid.origin, **f64))
    centers_unit = (centers_sfm - torch.as_tensor(scene_origin, **f64)) / float(scene_radius)
    t0 = time.perf_counter()
    sdf = sharded_sdf_sweep(model, fc, centers_unit.float().cpu().numpy(), chunk, device,
                            group=group)
    sweep_seconds = time.perf_counter() - t0
    keep = sdf <= sdf_threshold
    kept_frac = float(np.count_nonzero(keep)) / max(len(keep), 1)
    if stats_out is not None:
        stats_out.update(n_candidates=int(len(keep)), n_kept=int(np.count_nonzero(keep)),
                         kept_frac=kept_frac, sweep_seconds=sweep_seconds)
    if kept_frac > 0.9:
        # a near-total keep means the SDF has no zero set inside the
        # candidate region: the grid would recentre every ray band on the
        # region's boundary, a geometry collapse the rendering losses
        # cannot see
        logging.getLogger(__name__).warning(
            "surface refresh kept %.0f%% of candidate voxels — the SDF zero set is "
            "degenerate (all-negative level shift?); check depth/mask supervision strength",
            100.0 * kept_frac)
    return lin, centers_sfm, centers_unit, keep


def surface_selection(model, fc, sfm_grid: VoxelGrid, train_level: int,
                      scene_origin: np.ndarray, scene_radius: float,
                      sdf_threshold: float = 0.0, chunk: int = 65536,
                      stats_out: dict | None = None, group=None):
    """The cell centres (SFM and unit-sphere coordinates) whose SDF is <=
    the threshold (reference neuconw_system.py:186-266), as host arrays."""
    _, centers_sfm, centers_unit, keep = _swept_candidates(
        model, fc, sfm_grid, train_level, scene_origin, scene_radius, sdf_threshold, chunk,
        stats_out, group)
    keep = torch.from_numpy(keep).to(centers_sfm.device)
    return centers_sfm[keep].cpu().numpy(), centers_unit[keep].cpu().numpy()


def octree_update(model, fc, sfm_grid: VoxelGrid, scene_config: dict,
                  scene_origin: np.ndarray, scene_radius: float, train_voxel_size: float,
                  sdf_threshold: float = 0.0, chunk: int = 65536,
                  stats_out: dict | None = None, group=None
                  ) -> tuple[VoxelGrid, DeviceGrid] | tuple[None, None]:
    """The fine surface grid rebuilt from the current SDF (reference
    neuconw_system.py:268-312), in the SFM grid's cube, on the model's
    device: (host grid, device grid), or (None, None) when no cell
    survives, and the caller keeps its grid."""
    level = surface_level(scene_config, train_voxel_size)
    lin, _, _, keep = _swept_candidates(model, fc, sfm_grid, level, scene_origin, scene_radius,
                                        sdf_threshold, chunk, stats_out=stats_out, group=group)
    if not keep.any():
        return None, None
    # the reference quantises the kept centres back into the cube, which
    # gives each kept cell's own index (a centre lies half a cell from every
    # face): the densified cells are sorted and distinct, and so are the
    # kept ones
    kept = lin[torch.from_numpy(keep).to(lin.device)]
    host = VoxelGrid(level, sfm_grid.origin, sfm_grid.scale,
                     _cell_xyz(kept, level).to(torch.int32).cpu().numpy())
    # VoxelGrid.occupancy_words on the device: each kept cell sets a bit of
    # its own, so the sum of the bits is their OR
    words = torch.zeros(max((1 << 3 * level) // 32, 1), dtype=torch.int64, device=lin.device)
    words.index_add_(0, kept >> 5, torch.ones_like(kept) << (kept & 31))
    occ = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return host, device_grid_from_host(host, lin.device, occ=occ)
