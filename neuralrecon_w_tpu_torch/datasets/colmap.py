"""COLMAP ``points3D.bin`` I/O (``neuralrecon_w_tpu/datasets/colmap.py:59-66,
161-195``): the SFM points that mesh extraction builds its grid from, and
the writer that makes a synthetic workspace. The binary model format is
COLMAP's (https://colmap.github.io/format.html)."""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict

import numpy as np


@dataclasses.dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    points: Dict[int, Point3D] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            pid = struct.unpack("<Q", f.read(8))[0]
            xyz = np.frombuffer(f.read(24), dtype="<f8").copy()
            rgb = np.frombuffer(f.read(3), dtype=np.uint8).copy()
            (error,) = struct.unpack("<d", f.read(8))
            (track_len,) = struct.unpack("<Q", f.read(8))
            rec = np.frombuffer(f.read(8 * track_len), dtype="<i4").reshape(track_len, 2)
            points[pid] = Point3D(pid, xyz, rgb, np.float64(error), rec[:, 0].copy(),
                                  rec[:, 1].copy())
    return points


def write_points3d_binary(points: Dict[int, Point3D], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", p.id))
            f.write(np.asarray(p.xyz, dtype="<f8").tobytes())
            f.write(np.asarray(p.rgb, dtype=np.uint8).tobytes())
            f.write(struct.pack("<d", float(p.error)))
            track_len = len(p.image_ids)
            f.write(struct.pack("<Q", track_len))
            rec = np.empty((track_len, 2), dtype="<i4")
            rec[:, 0] = p.image_ids
            rec[:, 1] = p.point2D_idxs
            f.write(rec.tobytes())
