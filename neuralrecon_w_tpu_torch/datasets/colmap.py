"""COLMAP binary model I/O (``neuralrecon_w_tpu/datasets/colmap.py``):
``cameras.bin``, ``images.bin`` and ``points3D.bin`` readers and writers,
the quaternion conversions, and ``points3d_arrays``. The binary model
format is COLMAP's (https://colmap.github.io/format.html); the writers
produce the same bytes as the JAX package's."""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict

import numpy as np

# model_id -> (name, num_params), COLMAP's camera model registry
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class Image:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray  # (N, 2)
    point3D_ids: np.ndarray  # (N,) int64, -1 where unmatched

    def qvec2rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclasses.dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z) to rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix to quaternion (w, x, y, z), w >= 0."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1], R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q if q[0] >= 0 else -q


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cameras: Dict[int, Camera] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
            name, nparam = CAMERA_MODELS[mid]
            params = np.frombuffer(f.read(8 * nparam), dtype="<f8").copy()
            cameras[cid] = Camera(cid, name, int(w), int(h), params)
    return cameras


def write_cameras_binary(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            f.write(struct.pack("<iiQQ", cam.id, CAMERA_MODEL_IDS[cam.model], cam.width,
                                cam.height))
            f.write(np.asarray(cam.params, dtype="<f8").tobytes())


def read_images_binary(path: str) -> Dict[int, Image]:
    images: Dict[int, Image] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            qvec = np.frombuffer(f.read(32), dtype="<f8").copy()
            tvec = np.frombuffer(f.read(24), dtype="<f8").copy()
            (cam_id,) = struct.unpack("<i", f.read(4))
            name_bytes = bytearray()
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name_bytes += c
            (npts,) = struct.unpack("<Q", f.read(8))
            rec = np.frombuffer(f.read(24 * npts), dtype="<f8").reshape(npts, 3)
            images[iid] = Image(iid, qvec, tvec, cam_id, name_bytes.decode("utf-8"),
                                rec[:, :2].copy(), rec[:, 2].view("<i8").copy())
    return images


def write_images_binary(images: Dict[int, Image], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(np.asarray(im.qvec, dtype="<f8").tobytes())
            f.write(np.asarray(im.tvec, dtype="<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            npts = len(im.point3D_ids)
            f.write(struct.pack("<Q", npts))
            rec = np.empty((npts, 3), dtype="<f8")
            rec[:, :2] = im.xys
            rec[:, 2] = np.asarray(im.point3D_ids, dtype="<i8").view("<f8")
            f.write(rec.tobytes())


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


def points3d_arrays(points: Dict[int, Point3D]):
    """Dense arrays (xyz, error, track length) indexed by point id
    (``colmap.py:197-210``)."""
    max_id = max(points.keys())
    xyz = np.ones((max_id + 1, 3), dtype=np.float64)
    err = np.ones((max_id + 1,), dtype=np.float64)
    track = np.zeros((max_id + 1,), dtype=np.int64)
    for pid, p in points.items():
        xyz[pid] = p.xyz
        err[pid] = p.error
        track[pid] = len(p.point2D_idxs)
    return xyz, err, track
