"""Sparse voxel grid on the host (``neuralrecon_w_tpu/ops/voxel_grid.py``):
the occupied cells of a level-L grid over the cube [-1, 1]^3 centred at
``origin`` with half-extent ``scale`` (SFM units), and the packed
occupancy bitfield that ``ops/ray_voxel.py`` ships to the device.

What serving, training and mesh extraction build is here: the grid from
SFM points (from a workspace's ``points3D.bin`` and a bounding box of its
scene config, too), its cell centres and corners, and its subdivision
to a finer level. Its cells are
sorted by coordinate, where the JAX package sorts them by Morton code;
the occupancy, all that the device reads, and the cell set do not depend
on the order.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VoxelGrid:
    level: int
    origin: np.ndarray  # (3,) cube center, SFM coords
    scale: float  # cube half-extent, SFM units
    coords: np.ndarray  # (M, 3) int32 occupied cells

    @property
    def res(self) -> int:
        return 1 << self.level

    @property
    def voxel_size(self) -> float:
        """Edge length of one cell in SFM units (= 2 * scale / 2^level)."""
        return 2.0 * self.scale / self.res

    def centers_sfm(self) -> np.ndarray:
        """(M, 3) cell centres in SFM coordinates."""
        return ((self.coords.astype(np.float64) + 0.5) / self.res * 2.0 - 1.0) * self.scale \
            + self.origin

    def corners_sfm(self) -> np.ndarray:
        """(M, 3) cell min-corners in SFM coordinates (the cell index maps
        to its low corner)."""
        return (self.coords.astype(np.float64) / self.res * 2.0 - 1.0) * self.scale + self.origin

    def upsample(self, target_level: int) -> "VoxelGrid":
        """Every occupied cell subdivided to ``target_level``, all children
        occupied (``voxel_grid.py:73-90``)."""
        up = target_level - self.level
        if up < 0:
            raise ValueError(f"cannot upsample level {self.level} to {target_level}")
        if up == 0:
            return self
        t = 1 << up
        k = np.stack(np.meshgrid(np.arange(t), np.arange(t), np.arange(t), indexing="ij"),
                     axis=-1).reshape(-1, 3)
        coords = (self.coords.astype(np.int64)[:, None, :] * t + k[None, :, :]).reshape(-1, 3)
        return VoxelGrid(target_level, self.origin, self.scale, _sort_coords(coords, target_level))

    def occupancy_words(self) -> np.ndarray:
        """Packed occupancy bitfield, (2^{3L} / 32,) uint32: linear index
        ((x * N) + y) * N + z; word = idx >> 5, bit = idx & 31."""
        n = self.res
        idx = (self.coords[:, 0].astype(np.int64) * n + self.coords[:, 1]) * n + self.coords[:, 2]
        words = np.zeros((max(n * n * n // 32, 1),), dtype=np.uint32)
        np.bitwise_or.at(words, idx >> 5, np.uint32(1) << (idx & 31).astype(np.uint32))
        return words


def _linear(coords: np.ndarray, level: int) -> np.ndarray:
    n = np.int64(1) << level
    c = np.asarray(coords, np.int64)
    return (c[:, 0] * n + c[:, 1]) * n + c[:, 2]


def _from_linear(idx: np.ndarray, level: int) -> np.ndarray:
    n = np.int64(1) << level
    return np.stack([idx // (n * n), (idx // n) % n, idx % n], axis=1).astype(np.int32)


def _sort_coords(coords: np.ndarray, level: int) -> np.ndarray:
    """Distinct cells in coordinate order, through their linear index."""
    return _from_linear(np.unique(_linear(np.asarray(coords).reshape(-1, 3), level)), level)


def level_for_voxel_size(scale: float, voxel_size: float, mode: str = "floor") -> int:
    """Grid level for an SFM-space voxel size over a cube of half-extent
    ``scale``: floor when building the SFM grid, ceil for the training
    level (``voxel_grid.py:117-124``)."""
    raw = np.log2(2.0 * scale / voxel_size)
    return int(np.floor(raw)) if mode == "floor" else int(np.ceil(raw))


def grid_from_points(points: np.ndarray, bbx_min, bbx_max, voxel_size: float,
                     expand: int = 1, radius: float = 1.0) -> VoxelGrid:
    """Sparse grid from SFM points (``voxel_grid.py:127-170``): the cube
    of the bbx's largest extent (times ``radius``), ``expand`` rounds of
    27-neighbourhood dilation by ``voxel_size``, points kept inside the
    open cube, quantised at level floor(log2(2 * scale / voxel_size)).

    The dilation is the JAX package's native one (``csrc/geometry.cpp``,
    ``nw_expand_quantize``), in its float64 arithmetic: ``expand`` rounds
    of 27-neighbourhoods are the (2 * expand + 1)^3 offsets of one round,
    each point is moved by each offset and quantised, and only cells are
    kept, never the 27^expand copies of the cloud."""
    bbx_min = np.asarray(bbx_min, dtype=np.float64)
    bbx_max = np.asarray(bbx_max, dtype=np.float64)
    origin = bbx_min + (bbx_max - bbx_min) / 2.0
    scale = float(np.max(bbx_max - bbx_min) / 2.0 * radius)
    level = level_for_voxel_size(scale, voxel_size, "floor")
    res = 1 << level
    inv_span = 1.0 / (2.0 * scale)

    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    r = int(expand)
    cells = []
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dz in range(-r, r + 1):
                x = pts + np.array([dx, dy, dz], np.float64) * voxel_size
                n = (x - origin) * inv_span + 0.5
                n = n[np.all((n > 0.0) & (n < 1.0), axis=-1)]
                c = np.minimum((n * res).astype(np.int64), res - 1)
                cells.append(np.unique(_linear(c, level)))
    idx = np.unique(np.concatenate(cells)) if cells else np.zeros(0, np.int64)
    return VoxelGrid(level, origin, scale, _from_linear(idx, level))


def grid_from_sfm_points(scene_config: dict, points3d: dict, min_track_length: int,
                         voxel_size: float, expand: int = 1, radius: float = 1.0,
                         in_sfm: bool = True) -> VoxelGrid:
    """The SFM occupancy grid from parsed COLMAP points, those with a track
    longer than ``min_track_length``, over the scene's eval bbx in SFM
    coordinates (``voxel_grid.py:173-183``)."""
    pts = np.array([p.xyz for p in points3d.values()
                    if len(p.point2D_idxs) > min_track_length]).reshape(-1, 3)
    bbx_min, bbx_max = scene_bbx_sfm(scene_config, in_sfm=in_sfm)
    return grid_from_points(pts, bbx_min, bbx_max, voxel_size, expand, radius)


def scene_bbx_sfm(scene_config: dict, bbx_name: str = "eval_bbx", in_sfm: bool = True):
    """A bounding box of the scene config (``eval_bbx`` by default), taken
    from ground-truth to SFM coordinates through the inverse of ``sfm2gt``
    when ``in_sfm`` (``voxel_grid.py:186-197``)."""
    v1, v2 = (np.array(v, dtype=np.float64) for v in scene_config[bbx_name][:2])
    if in_sfm:
        gt_to_sfm = np.linalg.inv(np.array(scene_config["sfm2gt"], dtype=np.float64))
        v1, v2 = (gt_to_sfm[:3, :3] @ v + gt_to_sfm[:3, 3] for v in (v1, v2))
    return np.minimum(v1, v2), np.maximum(v1, v2)
