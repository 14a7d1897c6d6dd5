"""SDF isosurface mesh extraction (``neuralrecon_w_tpu/extraction/mesh.py``):
card sweeps, host meshing.

  * the lattice: dense over the training sphere, or the SFM voxel grid
    densified to ``eval_level``;
  * the SDF at every lattice point through the chunked sweep
    (``parallel/sweep.sharded_sdf_sweep``: K1 in float32);
  * a sparse lattice's SDF scattered into a dense field initialised to 1,
    with the 8-corner validity mask;
  * the native marching-tetrahedra mesher on the host (``ops/native.py``);
  * area-weighted vertex normals;
  * optionally vertex colours at view direction (0, 0, 1) and one
    appearance index (``sharded_rgb_sweep``: K6 in the activation dtype).

With a data group both sweeps are split over its ranks (``mesh.py:97-142``)
and every rank meshes the same field.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np

from ..device import default_device
from ..ops.isosurface import vertex_normals
from ..ops.native import marching_tetrahedra_native
from ..ops.voxel_grid import grid_from_sfm_points
from ..parallel.sweep import sharded_rgb_sweep, sharded_sdf_sweep
from ..utils.ply import write_ply


class MeshData(NamedTuple):
    verts: np.ndarray  # (V, 3) SFM coordinates
    faces: np.ndarray  # (F, 3)
    normals: np.ndarray  # (V, 3)
    colors: Optional[np.ndarray]  # (V, 3) uint8 or None


class EvalGrid(NamedTuple):
    """A lattice of SDF sample points: cell min-corners (``points_sfm``)
    and their indices into the dense (dim, dim, dim) field (None: the
    dense lattice itself)."""

    points_sfm: np.ndarray  # (N, 3) float64
    indices: Optional[np.ndarray]  # (N, 3) int64, None => dense grid
    dim: int
    vol_origin: np.ndarray  # (3,) SFM coords of grid index (0, 0, 0)
    voxel_size: float  # SFM units per cell


def dense_eval_grid(scene_origin, radius: float, dim: int) -> EvalGrid:
    """dim^3 lattice spanning the training sphere."""
    o = np.asarray(scene_origin, np.float64)
    axes = [np.linspace(o[i] - radius, o[i] + radius, dim) for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return EvalGrid(pts, None, dim, o - radius, 2.0 * radius / (dim - 1))


def box_eval_grid(bbx, dim: int) -> EvalGrid:
    """Dense cubic lattice over an axis-aligned box (its largest extent,
    about its centre)."""
    lo, hi = np.asarray(bbx[0], np.float64), np.asarray(bbx[1], np.float64)
    return dense_eval_grid((lo + hi) / 2, float(np.max(hi - lo) / 2), dim)


def sparse_eval_grid(scene_config: dict, points3d: dict, eval_level: int) -> EvalGrid:
    """The SFM voxel grid (no dilation) densified to eval_level."""
    base = grid_from_sfm_points(scene_config, points3d, scene_config["min_track_length"],
                                scene_config["voxel_size"], expand=0)
    up = base.upsample(eval_level)
    voxel_size = 2.0 / (1 << eval_level) * base.scale
    vol_origin = base.origin - base.scale
    pts = up.coords.astype(np.float64) * voxel_size + vol_origin
    return EvalGrid(pts, up.coords.astype(np.int64), 1 << eval_level, vol_origin, voxel_size)


def extract_mesh(model, fc, grid: EvalGrid, scene_origin, scene_radius: float,
                 chunk: int = 102144, with_color: bool = False, a_index: int = 1123,
                 chunk_rgb: int = 65536, device=None,
                 timings: Optional[dict] = None, group=None) -> MeshData | None:
    """The zero isosurface over the grid, vertices in SFM coordinates, or
    None when the surface is empty. ``device`` defaults to the card;
    ``timings``, when given, gets the wall seconds of each stage; ``group``
    splits the sweeps over its ranks."""
    device = default_device(device)
    timings = {} if timings is None else timings
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        timings[name] = now - clock[0]
        clock[0] = now

    scene_origin = np.asarray(scene_origin, np.float64)
    pts_unit = (grid.points_sfm - scene_origin) / scene_radius
    sdf = sharded_sdf_sweep(model, fc, pts_unit.astype(np.float32), chunk, device, group=group)
    lap("sdf sweep")

    if grid.indices is None:
        field = sdf.reshape(grid.dim, grid.dim, grid.dim)
        mask = None
    else:
        field = np.ones((grid.dim, grid.dim, grid.dim), np.float32)
        ind = grid.indices
        field[ind[:, 0], ind[:, 1], ind[:, 2]] = sdf
        mask = np.zeros((grid.dim, grid.dim, grid.dim), bool)
        mask[ind[:, 0], ind[:, 1], ind[:, 2]] = True
    lap("scatter")

    verts_grid, faces = marching_tetrahedra_native(field, level=0.0, mask=mask)
    del field, mask
    lap("marching")
    if len(verts_grid) == 0:
        return None
    verts_sfm = verts_grid * grid.voxel_size + grid.vol_origin
    norms = vertex_normals(verts_sfm, faces)
    lap("normals")

    colors = None
    if with_color:
        verts_unit = (verts_sfm - scene_origin) / scene_radius
        rgb = sharded_rgb_sweep(model, fc, verts_unit.astype(np.float32),
                                np.array([0.0, 0.0, 1.0], np.float32), a_index, chunk_rgb, device,
                                group=group)
        colors = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
        lap("colour sweep")
    return MeshData(verts_sfm, faces, norms, colors)


def save_mesh_ply(mesh_data: MeshData, path: str) -> None:
    write_ply(path, mesh_data.verts, faces=mesh_data.faces, colors=mesh_data.colors,
              normals=mesh_data.normals)
