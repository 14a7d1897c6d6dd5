"""Reprojection visibility filter of reconstructed geometry
(``neuralrecon_w_tpu/evaluation/reproj_filter.py``; reference
utils/reproj_filter.py:101-300): render the prediction from every training
camera, and keep the target vertices that at least one view observes, so
that geometry no camera saw is not scored.

Both of the reference's modes:

* **mesh mode** (faces present): the host z-buffer rasteriser
  (``csrc/host/geometry.cpp`` ``nw_rasterize_depth``, ``ops/native.py``)
  renders each view's depth, the valid pixels are back-projected to world
  points, and target vertices within 2 sqrt(2) voxel_size of one of them
  survive (a scipy cKDTree query, reference reproj_filter.py:236-241).
* **point-cloud mode** (no faces): the vertices are voxelised (up to level
  12) into a device grid, two-level from level 9 (``ops/ray_voxel.HierGrid``,
  K12; below, the flat grid and K10), and every camera's pixel rays are
  marched on the card in fixed-size batches; a hit pixel contributes the
  cell of its first intersected voxel, and a vertex survives if its cell
  was hit from any view (the reference's kaolin voxel-id match,
  utils/kaolin_renderer.py:110-141).

Cells are matched by their linear index ((x * N) + y) * N + z, where the JAX
package uses Morton codes; the keep mask and the kept vertices and faces,
all that leaves the module, are the same. ``stats`` (a dict, optional)
gathers each stage's host seconds and the DDA's ray count.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..datasets.rays import get_ray_directions, get_rays
from ..ops.native import rasterize_depth_native
from ..ops.ray_voxel import make_device_grid, traverse
from ..ops.voxel_grid import VoxelGrid, _linear, _sort_coords, level_for_voxel_size

# the deepest grid the filter builds: it bounds the DDA's worst-case trips
MAX_LEVEL = 12


def _tick(stats, key: str, t0: float) -> float:
    """Add the seconds since t0 to stats[key]; the time now."""
    now = time.perf_counter()
    if stats is not None:
        stats[key] = stats.get(key, 0.0) + now - t0
    return now


def voxelize_points(verts: np.ndarray, voxel_size: float) -> VoxelGrid:
    """The bounding-cube grid of a vertex set at ``voxel_size``, at most
    level 12 (reference kaolin_renderer.vertex_table,
    utils/kaolin_renderer.py:60-108)."""
    vmin, vmax = verts.min(axis=0), verts.max(axis=0)
    origin = (vmin + vmax) / 2
    scale = float(np.max(vmax - vmin) / 2 * 1.01 + 1e-6)
    level = min(max(level_for_voxel_size(scale, voxel_size, "floor"), 1), MAX_LEVEL)
    res = 1 << level
    cells = np.clip(np.floor(((verts - origin) / scale + 1.0) / 2.0 * res), 0,
                    res - 1).astype(np.int64)
    return VoxelGrid(level, origin, scale, _sort_coords(cells, level))


def vertex_voxel_codes(grid: VoxelGrid, verts: np.ndarray) -> np.ndarray:
    """Linear cell index of each vertex in ``grid``."""
    res = grid.res
    cells = np.clip(np.floor(((verts - grid.origin) / grid.scale + 1.0) / 2.0 * res), 0,
                    res - 1).astype(np.int64)
    return _linear(cells, grid.level)


def _march(dgrid, grid: VoxelGrid, o: np.ndarray, d: np.ndarray):
    """First hits of rays in grid-normalised coordinates on the grid's
    device: (t_first, hit) as numpy."""
    dev = dgrid.origin.device
    t_first, _, hit = traverse(dgrid, grid.level,
                               torch.from_numpy(np.ascontiguousarray(o, np.float32)).to(dev),
                               torch.from_numpy(np.ascontiguousarray(d, np.float32)).to(dev),
                               first_only=True)
    return t_first.cpu().numpy(), hit.cpu().numpy()


def _hit_codes(grid: VoxelGrid, o, d, t_first, hit) -> np.ndarray:
    """Cells of the hit rays' first voxels, quantised on the host just past
    the entry point."""
    pos = o[hit] + d[hit] * (t_first[hit, None] + 1e-5)
    cells = np.clip(np.floor((pos + 1.0) / (2.0 / grid.res)), 0, grid.res - 1).astype(np.int64)
    return _linear(cells, grid.level)


def render_hit_codes(dgrid, grid: VoxelGrid, K: np.ndarray, c2w: np.ndarray, img_wh: tuple,
                     chunk: int = 262144) -> np.ndarray:
    """The distinct cells first hit by the pixel rays of one view (the
    device DDA, host quantisation of the entry points)."""
    w, h = img_wh
    rays_o, rays_d = get_rays(get_ray_directions(h, w, K), c2w)
    codes = []
    for i in range(0, len(rays_o), chunk):
        o = (rays_o[i:i + chunk] - grid.origin) / grid.scale
        d = rays_d[i:i + chunk]
        t_first, hit = _march(dgrid, grid, o, d)
        if hit.any():
            codes.append(_hit_codes(grid, o, d, t_first, hit))
    return np.unique(np.concatenate(codes)) if codes else np.zeros(0, np.int64)


def render_hit_codes_multi(dgrid, grid: VoxelGrid, cameras: list, chunk: int = 262144,
                           stats: dict | None = None) -> np.ndarray:
    """The distinct first-hit cells over many views, their rays packed into
    DDA calls of exactly ``chunk`` rays: views are buffered until a chunk's
    worth is there, and the last batch is padded with rays that miss the
    cube (the throughput role of the reference's ``ray`` actors, reference
    utils/reproj_filter.py:172,277-288)."""
    codes = []
    buf_o, buf_d, n_buf = [], [], 0

    def flush():
        nonlocal buf_o, buf_d, n_buf
        if n_buf == 0:
            return
        t0 = time.perf_counter()
        o = (np.concatenate(buf_o) - grid.origin) / grid.scale
        d = np.concatenate(buf_d)
        n = len(o)
        pad = (-n) % chunk
        if pad:  # origins outside the cube, parallel to z: sure misses
            o = np.concatenate([o, np.full((pad, 3), 4.0)])
            d = np.concatenate([d, np.tile([[0.0, 0.0, 1.0]], (pad, 1))])
        t0 = _tick(stats, "rays_s", t0)
        for i in range(0, len(o), chunk):
            t_first, hit = _march(dgrid, grid, o[i:i + chunk], d[i:i + chunk])
            t0 = _tick(stats, "dda_s", t0)
            m = max(min(n - i, chunk), 0)
            t_first, hit = t_first[:m], hit[:m]
            if stats is not None:
                stats["dda_calls"] = stats.get("dda_calls", 0) + 1
                stats["dda_rays"] = stats.get("dda_rays", 0) + chunk
            if hit.any():
                codes.append(_hit_codes(grid, o[i:i + m], d[i:i + m], t_first, hit))
            t0 = _tick(stats, "quantise_s", t0)
        buf_o, buf_d, n_buf = [], [], 0

    for K, c2w, (w, h) in cameras:
        t0 = time.perf_counter()
        rays_o, rays_d = get_rays(get_ray_directions(h, w, K), c2w)
        buf_o.append(rays_o)
        buf_d.append(rays_d)
        n_buf += len(rays_o)
        _tick(stats, "rays_s", t0)
        if n_buf >= chunk:
            flush()
    flush()
    t0 = time.perf_counter()
    out = np.unique(np.concatenate(codes)) if codes else np.zeros(0, np.int64)
    _tick(stats, "quantise_s", t0)
    return out


def voxel_depth_map(dgrid, grid: VoxelGrid, K: np.ndarray, c2w: np.ndarray, img_wh: tuple,
                    chunk: int = 262144) -> np.ndarray:
    """(h, w) first-hit depth in SFM units (0 = miss) of one view: the depth
    raster of the reference's kaolin renderer (utils/kaolin_renderer.py:110-141)."""
    w, h = img_wh
    rays_o, rays_d = get_rays(get_ray_directions(h, w, K), c2w)
    depth = np.zeros(len(rays_o), np.float32)
    for i in range(0, len(rays_o), chunk):
        o = (rays_o[i:i + chunk] - grid.origin) / grid.scale
        t_first, hit = _march(dgrid, grid, o, rays_d[i:i + chunk])
        depth[i:i + chunk] = np.where(hit, t_first * grid.scale, 0.0)
    return depth.reshape(h, w)


def _rasterize_depth_numpy(verts, faces, c2w, K, width, height, znear=1e-4):
    """The plain version of ``nw_rasterize_depth``: a per-face z-buffer loop
    with the same conventions (NeRF c2w in, CV z-depth out, 0 = miss), but
    faces with a vertex behind znear dropped where the native one clips."""
    R = np.asarray(c2w, np.float64)[:3, :3]
    t = np.asarray(c2w, np.float64)[:3, 3]
    cam = (verts - t) @ R * np.array([1.0, -1.0, -1.0])  # CV: z forward
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    zbuf = np.full((height, width), np.inf, np.float32)
    tri = cam[np.asarray(faces, np.int64)]  # (F, 3, 3)
    ok = (tri[:, :, 2] > znear).all(axis=1)
    for a, b, c in tri[ok]:
        pa = np.array([fx * a[0] / a[2] + cx, fy * a[1] / a[2] + cy])
        pb = np.array([fx * b[0] / b[2] + cx, fy * b[1] / b[2] + cy])
        pc = np.array([fx * c[0] / c[2] + cx, fy * c[1] / c[2] + cy])
        area = (pb[0] - pa[0]) * (pc[1] - pa[1]) - (pb[1] - pa[1]) * (pc[0] - pa[0])
        if abs(area) < 1e-12:
            continue
        x0 = max(int(np.floor(min(pa[0], pb[0], pc[0]))), 0)
        x1 = min(int(np.ceil(max(pa[0], pb[0], pc[0]))), width - 1)
        y0 = max(int(np.floor(min(pa[1], pb[1], pc[1]))), 0)
        y1 = min(int(np.ceil(max(pa[1], pb[1], pc[1]))), height - 1)
        if x1 < x0 or y1 < y0:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        w0 = ((pb[0] - xs) * (pc[1] - ys) - (pb[1] - ys) * (pc[0] - xs)) / area
        w1 = ((pc[0] - xs) * (pa[1] - ys) - (pc[1] - ys) * (pa[0] - xs)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        iz = w0 / a[2] + w1 / b[2] + w2 / c[2]
        z = np.where(inside, 1.0 / np.maximum(iz, 1e-12), np.inf).astype(np.float32)
        patch = zbuf[y0:y1 + 1, x0:x1 + 1]
        np.minimum(patch, z, out=patch)
    return np.where(np.isinf(zbuf), 0.0, zbuf)


def mesh_depth_map(verts, faces, K, c2w, img_wh, znear=1e-4) -> np.ndarray:
    """(h, w) z-buffer depth of the mesh from one camera, 0 = miss (the
    reference's pyrender offscreen render, utils/pyrender_renderer.py:4-39),
    by the native rasteriser."""
    w, h = img_wh
    return rasterize_depth_native(verts, faces, c2w, K, w, h, znear)


def backproject_depth(depth, K, c2w) -> np.ndarray:
    """World points of the valid depth pixels (reference reproject(),
    utils/reproj_filter.py:133-152): pc_cam = K^-1 [u, v, 1]^T z."""
    v, u = np.nonzero(depth > 0)
    if len(u) == 0:
        return np.zeros((0, 3), np.float64)
    z = depth[v, u].astype(np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    cam = np.stack([(u - cx) / fx * z, -((v - cy) / fy * z), -z], axis=-1)  # CV -> NeRF
    R = np.asarray(c2w, np.float64)[:3, :3]
    t = np.asarray(c2w, np.float64)[:3, 3]
    return cam @ R.T + t


def reprojection_filter(verts: np.ndarray, faces: np.ndarray | None, cameras: list,
                        voxel_size: float, chunk: int = 262144,
                        target_verts: np.ndarray | None = None, workers: int = 0,
                        device=None, stats: dict | None = None):
    """Keep the vertices that at least one training view observes.

    verts: (V, 3) SFM-frame vertices, the render source and by default the
    target; faces: optional (F, 3) triangles (mesh mode), else point-cloud
    mode; cameras: [(K 3x3, c2w 3x4, (w, h))]; voxel_size: the match scale
    in SFM units; target_verts: another vertex set to filter; workers > 0:
    views on a thread pool in mesh mode (the rasteriser and scipy release
    the GIL); device: where the point-cloud DDA runs (default: the card).
    Returns (kept_verts, kept_faces, keep_mask) over the target set;
    kept_faces only in mesh mode without target_verts, remapped."""
    target = verts if target_verts is None else target_verts
    mesh_mode = faces is not None and len(faces)
    if mesh_mode:
        from scipy.spatial import cKDTree

        t0 = time.perf_counter()
        tree = cKDTree(target)
        radius = 2.0 * np.sqrt(2.0) * voxel_size
        keep = np.zeros(len(target), bool)
        _tick(stats, "tree_s", t0)

        def view_hits(cam):
            """The target vertices one view observes, and its (raster,
            match) seconds."""
            K, c2w, wh = cam
            t0 = time.perf_counter()
            depth = mesh_depth_map(verts, faces, K, c2w, wh)
            t1 = time.perf_counter()
            pts = backproject_depth(depth, K, c2w)
            if not len(pts):
                return np.zeros(0, np.int64), t1 - t0, 0.0
            d, idx = tree.query(pts, k=1, distance_upper_bound=radius)
            return idx[np.isfinite(d)], t1 - t0, time.perf_counter() - t1

        if workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=workers) as pool:
                views = list(pool.map(view_hits, cameras))
        else:
            views = [view_hits(cam) for cam in cameras]
        for idx, raster_s, match_s in views:  # seconds summed over the views' threads
            keep[idx] = True
            if stats is not None:
                stats["raster_s"] = stats.get("raster_s", 0.0) + raster_s
                stats["match_s"] = stats.get("match_s", 0.0) + match_s
    else:
        t0 = time.perf_counter()
        grid = voxelize_points(verts, voxel_size)
        t0 = _tick(stats, "voxelize_s", t0)
        dgrid = make_device_grid(grid, device=device)
        _tick(stats, "grid_s", t0)
        if stats is not None:
            stats["level"], stats["cells"] = grid.level, len(grid.coords)
        observed = render_hit_codes_multi(dgrid, grid, cameras, chunk, stats)
        t0 = time.perf_counter()
        keep = np.isin(vertex_voxel_codes(grid, target), observed)
        _tick(stats, "isin_s", t0)

    kept_faces = None
    if mesh_mode and target_verts is None:
        remap = -np.ones(len(target), np.int64)
        remap[keep] = np.arange(keep.sum())
        f = remap[faces]
        kept_faces = f[(f >= 0).all(axis=1)]
    return target[keep], kept_faces, keep
