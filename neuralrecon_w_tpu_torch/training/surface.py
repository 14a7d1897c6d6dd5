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
(``surface.py:55``, the JAX package's sweep over its mesh). The rebuilt
grid goes to the device as a packed bitfield.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from ..ops.ray_voxel import DeviceGrid, device_grid_from_host
from ..ops.voxel_grid import VoxelGrid, _sort_coords, level_for_voxel_size, scene_bbx_sfm
from ..parallel.sweep import sharded_sdf_sweep


def surface_level(scene_config: dict, train_voxel_size: float) -> int:
    """The level whose cells are <= train_voxel_size over the scene cube
    (reference neuconw_system.py:314-335 rounds up)."""
    bbx_min, bbx_max = scene_bbx_sfm(scene_config, in_sfm=True)
    scale = float(np.max(bbx_max - bbx_min) / 2.0)
    return level_for_voxel_size(scale, train_voxel_size, mode="ceil")


def surface_selection(model, fc, sfm_grid: VoxelGrid, train_level: int,
                      scene_origin: np.ndarray, scene_radius: float,
                      sdf_threshold: float = 0.0, chunk: int = 65536,
                      stats_out: dict | None = None, group=None):
    """The cell centres (SFM and unit-sphere coordinates) whose SDF is <=
    the threshold (reference neuconw_system.py:186-266). ``stats_out``, when
    given, gets n_candidates / n_kept / kept_frac and the sweep's wall
    seconds (sweep_seconds); a keep above 90 % warns."""
    dense = sfm_grid.upsample(train_level)
    centers_sfm = dense.centers_sfm()
    centers_unit = (centers_sfm - scene_origin) / scene_radius
    device = next(model.parameters()).device
    t0 = time.perf_counter()
    sdf = sharded_sdf_sweep(model, fc, centers_unit.astype(np.float32), chunk, device,
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
    return centers_sfm[keep], centers_unit[keep]


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
    centers_sfm, _ = surface_selection(model, fc, sfm_grid, level, scene_origin, scene_radius,
                                       sdf_threshold, chunk, stats_out=stats_out,
                                       group=group)
    if len(centers_sfm) == 0:
        return None, None
    res = 1 << level
    cells = np.clip(np.floor(((centers_sfm - sfm_grid.origin) / sfm_grid.scale + 1.0)
                             / 2.0 * res), 0, res - 1).astype(np.int64)
    host = VoxelGrid(level, sfm_grid.origin, sfm_grid.scale, _sort_coords(cells, level))
    return host, device_grid_from_host(host, next(model.parameters()).device)

