"""Isosurface extraction by vectorised marching tetrahedra, the port's
numpy copy of ``neuralrecon_w_tpu/ops/isosurface.py``. Each grid cell is
split into 6 tetrahedra sharing the main diagonal; each tetrahedron with a
sign change emits 1-2 triangles with vertices linearly interpolated along
its edges, deduplicated by (global corner pair) edge keys. A cell is
processed only when all 8 of its corners carry valid samples (the sparse
grid's mask).

This is the plain version of the native mesher (``ops/native.py``), which
extraction runs: at level 10 this one would materialise (1023^3, 8, 3)
int64 corner indices. The tests hold the two to each other.
"""

from __future__ import annotations

import numpy as np

# cube corners in (x, y, z) bit order: corner c = (c>>2 & 1, c>>1 & 1, c & 1)
_CORNER_OFFSETS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], dtype=np.int64
)

# six tetrahedra around the main diagonal 0 -> 7 (a standard decomposition;
# all six share corners 0 and 7, consistent across neighboring cells)
_TETS = np.array(
    [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7],
     [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]], dtype=np.int64
)

# tetrahedron edges (local corner index pairs 0..3)
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)

# For each of the 16 sign configurations (bit i set = corner i inside,
# i.e. value < iso): triangles as triples of tet-edge indices, padded
# with -1. Orientation follows outward normals for "inside = negative".
_TET_TRI_TABLE = -np.ones((16, 2, 3), dtype=np.int64)


def _build_tet_table():
    # canonical single-corner and two-corner cases; derived by symmetry
    tbl = {
        0b0001: [[0, 1, 2]],             # corner 0 inside
        0b0010: [[0, 4, 3]],             # corner 1
        0b0100: [[1, 3, 5]],             # corner 2
        0b1000: [[2, 5, 4]],             # corner 3
        0b0011: [[1, 4, 3], [1, 2, 4]],  # corners 0, 1
        0b0101: [[0, 3, 5], [0, 5, 2]],  # corners 0, 2
        0b1001: [[0, 1, 5], [0, 5, 4]],  # corners 0, 3
        0b0110: [[0, 4, 5], [0, 5, 1]],  # corners 1, 2
        0b1010: [[0, 2, 5], [0, 5, 3]],  # corners 1, 3
        0b1100: [[1, 3, 4], [1, 4, 2]],  # corners 2, 3
    }
    # complements: same edges, reversed winding
    for mask, tris in list(tbl.items()):
        comp = (~mask) & 0xF
        if comp not in tbl:
            tbl[comp] = [t[::-1] for t in tris]
    for mask, tris in tbl.items():
        for ti, t in enumerate(tris):
            _TET_TRI_TABLE[mask, ti] = t


_build_tet_table()


def marching_tetrahedra(
    sdf: np.ndarray, level: float = 0.0, mask: np.ndarray | None = None
):
    """Extract the ``level`` isosurface of a dense scalar grid.

    Args:
        sdf: (D0, D1, D2) scalar field sampled at grid points.
        level: iso value.
        mask: optional (D0, D1, D2) bool point-validity mask; cells with
            any invalid corner are skipped.
    Returns:
        verts: (V, 3) float64 in grid-index coordinates (like skimage).
        faces: (F, 3) int64 vertex indices.
    """
    d0, d1, d2 = sdf.shape
    if min(d0, d1, d2) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    inside = sdf < level  # (D0, D1, D2) bool

    # candidate cells: any corner sign differs, all corners valid
    cell_idx = np.stack(
        np.meshgrid(
            np.arange(d0 - 1), np.arange(d1 - 1), np.arange(d2 - 1), indexing="ij"
        ),
        axis=-1,
    ).reshape(-1, 3)

    corner_xyz = cell_idx[:, None, :] + _CORNER_OFFSETS[None, :, :]  # (C, 8, 3)
    ci = corner_xyz.reshape(-1, 3)
    corner_in = inside[ci[:, 0], ci[:, 1], ci[:, 2]].reshape(-1, 8)
    active = corner_in.any(axis=1) & ~corner_in.all(axis=1)
    if mask is not None:
        corner_valid = mask[ci[:, 0], ci[:, 1], ci[:, 2]].reshape(-1, 8)
        active &= corner_valid.all(axis=1)
    if not active.any():
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    cells = cell_idx[active]  # (A, 3)
    corner_xyz = cells[:, None, :] + _CORNER_OFFSETS[None, :, :]  # (A, 8, 3)
    flat = corner_xyz.reshape(-1, 3)
    corner_val = sdf[flat[:, 0], flat[:, 1], flat[:, 2]].reshape(-1, 8)
    # global corner ids for vertex dedup across cells
    corner_gid = (flat[:, 0] * d1 + flat[:, 1]) * d2 + flat[:, 2]
    corner_gid = corner_gid.reshape(-1, 8)

    all_tri_edges = []  # (T, 3, 2) global corner id pairs
    for tet in _TETS:
        vals = corner_val[:, tet]  # (A, 4)
        gids = corner_gid[:, tet]
        case = (
            (vals[:, 0] < level).astype(np.int64)
            | ((vals[:, 1] < level) << 1)
            | ((vals[:, 2] < level) << 2)
            | ((vals[:, 3] < level) << 3)
        )
        tris = _TET_TRI_TABLE[case]  # (A, 2, 3) edge indices or -1
        for t in range(2):
            tri = tris[:, t, :]  # (A, 3)
            sel = tri[:, 0] >= 0
            if not sel.any():
                continue
            tri = tri[sel]
            g = gids[sel]
            # per triangle: 3 edges -> corner pairs
            e = _TET_EDGES[tri]  # (K, 3, 2) local corner indices
            pair = np.take_along_axis(
                g[:, None, :].repeat(3, axis=1), e, axis=2
            )  # (K, 3, 2) global ids
            all_tri_edges.append(pair)

    if not all_tri_edges:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tri_pairs = np.concatenate(all_tri_edges, axis=0)  # (T, 3, 2)

    # canonical edge keys + dedup
    lo = np.minimum(tri_pairs[..., 0], tri_pairs[..., 1])
    hi = np.maximum(tri_pairs[..., 0], tri_pairs[..., 1])
    keys = lo.astype(np.uint64) * np.uint64(d0 * d1 * d2) + hi.astype(np.uint64)
    uniq, inv = np.unique(keys.reshape(-1), return_inverse=True)
    faces = inv.reshape(-1, 3)

    # interpolate unique edge vertices
    ulo = (uniq // np.uint64(d0 * d1 * d2)).astype(np.int64)
    uhi = (uniq % np.uint64(d0 * d1 * d2)).astype(np.int64)

    def gid_to_xyz(g):
        z = g % d2
        y = (g // d2) % d1
        x = g // (d1 * d2)
        return np.stack([x, y, z], axis=-1).astype(np.float64)

    p_lo, p_hi = gid_to_xyz(ulo), gid_to_xyz(uhi)
    v_lo = sdf[ulo // (d1 * d2), (ulo // d2) % d1, ulo % d2]
    v_hi = sdf[uhi // (d1 * d2), (uhi // d2) % d1, uhi % d2]
    denom = v_hi - v_lo
    t = np.where(np.abs(denom) < 1e-12, 0.5, (level - v_lo) / np.where(denom == 0, 1, denom))
    t = np.clip(t, 0.0, 1.0)
    verts = p_lo + t[:, None] * (p_hi - p_lo)

    # drop degenerate faces (duplicate vertices)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[ok]


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals."""
    n = np.zeros_like(verts)
    if len(faces) == 0:
        return n
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    for i in range(3):
        np.add.at(n, faces[:, i], fn)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(norm, 1e-12)
