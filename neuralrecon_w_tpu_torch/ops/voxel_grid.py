"""Sparse voxel grid on the host (``neuralrecon_w_tpu/ops/voxel_grid.py``):
the occupied cells of a level-L grid over the cube [-1, 1]^3 centred at
``origin`` with half-extent ``scale`` (SFM units), and the packed
occupancy bitfield that ``ops/ray_voxel.py`` ships to the device.

Only what serving builds is here: the grid from SFM points. Its cells are
sorted by coordinate, where the JAX package sorts them by Morton code;
the occupancy, all that the device reads, does not depend on the order.
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

    def occupancy_words(self) -> np.ndarray:
        """Packed occupancy bitfield, (2^{3L} / 32,) uint32: linear index
        ((x * N) + y) * N + z; word = idx >> 5, bit = idx & 31."""
        n = self.res
        idx = (self.coords[:, 0].astype(np.int64) * n + self.coords[:, 1]) * n + self.coords[:, 2]
        words = np.zeros((max(n * n * n // 32, 1),), dtype=np.uint32)
        np.bitwise_or.at(words, idx >> 5, np.uint32(1) << (idx & 31).astype(np.uint32))
        return words


def grid_from_points(points: np.ndarray, bbx_min, bbx_max, voxel_size: float,
                     expand: int = 1, radius: float = 1.0) -> VoxelGrid:
    """Sparse grid from SFM points (``voxel_grid.py:127-170``): the cube
    of the bbx's largest extent (times ``radius``), ``expand`` rounds of
    27-neighbourhood dilation by ``voxel_size``, points kept inside the
    open cube, quantised at level floor(log2(2 * scale / voxel_size))."""
    bbx_min = np.asarray(bbx_min, dtype=np.float64)
    bbx_max = np.asarray(bbx_max, dtype=np.float64)
    origin = bbx_min + (bbx_max - bbx_min) / 2.0
    scale = float(np.max(bbx_max - bbx_min) / 2.0 * radius)
    level = int(np.floor(np.log2(2.0 * scale / voxel_size)))

    pts = np.asarray(points, dtype=np.float64)
    offsets = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1], indexing="ij"),
                       axis=-1).reshape(-1, 3) * voxel_size
    for _ in range(int(expand)):
        pts = np.unique((pts[None, :, :] + offsets[:, None, :]).reshape(-1, 3), axis=0)

    normalized = (pts - origin) / scale
    normalized = normalized[np.all(np.abs(normalized) < 1.0, axis=-1)]
    res = 1 << level
    cells = np.clip(np.floor((normalized + 1.0) / 2.0 * res), 0, res - 1).astype(np.int64)
    return VoxelGrid(level, origin, scale, np.unique(cells, axis=0).astype(np.int32))
