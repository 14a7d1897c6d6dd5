"""The host geometry library (``csrc/host/geometry.cpp``): the mesher of
mesh extraction and the depth rasteriser of the reprojection filter. Built
with ``g++`` at first use into ``build/neuralrecon_w_tpu_torch/`` under the
checkout root, named by a hash of the source and flags as ``ops/build.py``
names the kernels, and loaded with ctypes
(``neuralrecon_w_tpu/ops/native.py:40-60``'s argtypes).

There is no fallback: at level 10 the numpy mesher (``ops/isosurface.py``)
would materialise (1023^3, 8, 3) int64 corner indices, ~200 GB, and the
numpy rasteriser (``evaluation/reproj_filter._rasterize_depth_numpy``)
drops every face that crosses the near plane. A failed build raises with
the compiler's log.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

from .build import BUILD_DIR, CSRC

SOURCE = os.path.join(CSRC, "host", "geometry.cpp")
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnw_geometry_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the mesher unless this exact build exists; its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host mesher builds with g++")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    lib.nw_marching_tetrahedra.restype = ctypes.c_int
    lib.nw_marching_tetrahedra.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.nw_rasterize_depth.restype = None
    lib.nw_rasterize_depth.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def rasterize_depth_native(verts: np.ndarray, faces: np.ndarray, c2w: np.ndarray,
                           K: np.ndarray, width: int, height: int,
                           znear: float = 1e-4) -> np.ndarray:
    """(h, w) float32 z-buffer depth of a mesh from a NeRF-convention camera
    (0 = miss), ``neuralrecon_w_tpu/ops/native.py:91-111``."""
    lib = library()
    v = np.ascontiguousarray(verts, np.float64)
    f = np.ascontiguousarray(faces, np.int64)
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("rasterize_depth_native: face indices outside the vertices")
    pose = np.ascontiguousarray(np.asarray(c2w, np.float64)[:3, :4])
    depth = np.zeros(int(height) * int(width), np.float32)
    lib.nw_rasterize_depth(
        _ptr(v, ctypes.c_double), len(v), _ptr(f, ctypes.c_int64), len(f),
        _ptr(pose, ctypes.c_double),
        float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]),
        int(width), int(height), float(znear), _ptr(depth, ctypes.c_float))
    return depth.reshape(int(height), int(width))


def marching_tetrahedra_native(sdf: np.ndarray, level: float = 0.0,
                               mask: np.ndarray | None = None,
                               max_verts: int = 1 << 22, max_faces: int = 1 << 23):
    """(verts (V, 3) float64 in grid-index coordinates, faces (F, 3) int64),
    as ``ops/isosurface.marching_tetrahedra`` gives them but in the order
    the cells are scanned. The output buffers start at max_verts /
    max_faces rows and grow 4x (and the scan reruns) when they fall short."""
    lib = library()
    field = np.ascontiguousarray(sdf, np.float32)
    d0, d1, d2 = field.shape
    mptr = ctypes.POINTER(ctypes.c_uint8)()
    if mask is not None:
        m = np.ascontiguousarray(mask, np.uint8)
        mptr = _ptr(m, ctypes.c_uint8)
    while True:
        verts = np.empty((max_verts, 3), np.float64)
        faces = np.empty((max_faces, 3), np.int64)
        nv, nf = ctypes.c_int64(), ctypes.c_int64()
        rc = lib.nw_marching_tetrahedra(
            _ptr(field, ctypes.c_float), mptr, d0, d1, d2, float(level),
            _ptr(verts, ctypes.c_double), max_verts, _ptr(faces, ctypes.c_int64), max_faces,
            ctypes.byref(nv), ctypes.byref(nf))
        if rc == 0:
            return verts[: nv.value].copy(), faces[: nf.value].copy()
        max_verts *= 4
        max_faces *= 4
