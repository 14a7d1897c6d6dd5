"""PLY mesh I/O, the port's copy of ``neuralrecon_w_tpu/utils/ply.py``:
``write_ply`` writes the extracted mesh (binary little endian, float
vertices and normals, uchar colours, int face lists); ``read_ply`` reads
that and the files other tools write (ground-truth scans, point clouds):
binary little endian or ASCII, any scalar type, any face-list types,
n-gons."""

from __future__ import annotations

import numpy as np


def write_ply(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    normals: np.ndarray | None = None,
    comment: str = "neuralrecon_w_tpu_torch",
) -> None:
    verts = np.asarray(verts, dtype="<f4")
    n_vert = len(verts)
    header = ["ply", "format binary_little_endian 1.0", f"comment {comment}"]
    header.append(f"element vertex {n_vert}")
    header += ["property float x", "property float y", "property float z"]
    if normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        header += [
            "property uchar red", "property uchar green", "property uchar blue"
        ]
    if faces is not None:
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    fields = [("xyz", "<f4", 3)]
    if normals is not None:
        fields.append(("n", "<f4", 3))
    if colors is not None:
        fields.append(("rgb", "u1", 3))
    dtype = np.dtype([(name, t, cnt) for name, t, cnt in fields])
    rec = np.empty(n_vert, dtype=dtype)
    rec["xyz"] = verts
    if normals is not None:
        rec["n"] = np.asarray(normals, dtype="<f4")
    if colors is not None:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = np.clip(c, 0, 255).astype(np.uint8)
        rec["rgb"] = c

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
        if faces is not None and len(faces):
            fdt = np.dtype([("cnt", "u1"), ("idx", "<i4", 3)])
            frec = np.empty(len(faces), dtype=fdt)
            frec["cnt"] = 3
            frec["idx"] = np.asarray(faces, dtype="<i4")
            f.write(frec.tobytes())


_PLY_TYPES = {
    "float": ("<f4", 4), "float32": ("<f4", 4),
    "double": ("<f8", 8), "float64": ("<f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "char": ("i1", 1), "int8": ("i1", 1),
    "short": ("<i2", 2), "ushort": ("<u2", 2),
    "int": ("<i4", 4), "int32": ("<i4", 4),
    "uint": ("<u4", 4), "uint32": ("<u4", 4),
}


def read_ply(path: str) -> dict:
    """Read a PLY file, binary little endian or ASCII
    (``neuralrecon_w_tpu/utils/ply.py:76-170``): 'verts' (V, 3) float64, and
    where the file has them 'normals' (V, 3) float64, 'colors' (V, 3) uint8
    and 'faces' (F, 3) int64, n-gons fan-triangulated. Scalars of any type
    in ``_PLY_TYPES``, face lists of any count and index types; elements
    other than vertex and face are read past."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = None
        elements = []  # (name, count, [("scalar", type, name) | ("list", cnt_t, idx_t, name)])
        while (line := f.readline().decode("ascii").strip()) != "end_header":
            tok = line.split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property" and tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            elif tok[0] == "property":
                elements[-1][2].append(("scalar", tok[1], tok[2]))
        out = {}
        if fmt == "ascii":
            _read_ascii_body(f, elements, out)
        elif fmt == "binary_little_endian":
            _read_binary_body(f, elements, out)
        else:
            raise ValueError(f"{path}: unsupported format {fmt}")
    return out


def _fan(n: int, idx) -> list:
    """Triangles (idx[0], idx[k], idx[k + 1]) of an n-gon."""
    return [[idx[0], idx[k], idx[k + 1]] for k in range(1, n - 1)]


def _is_face_list(name, props, p) -> bool:
    """Whether list property p of element ``name`` holds the face's vertex
    indices: its standard name, or the face element's only list."""
    lists = [q for q in props if q[0] == "list"]
    return name == "face" and (p[3] in ("vertex_indices", "vertex_index") or len(lists) == 1)


def _read_binary_body(f, elements, out):
    for name, count, props in elements:
        if all(p[0] == "scalar" for p in props):
            dtype = np.dtype([(p[2], _PLY_TYPES[p[1]][0]) for p in props])
            rec = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
            _collect_vertex_fields(name, rec, {p[2] for p in props}, out)
            continue
        if name == "face" and len(props) == 1:
            # all triangles (what write_ply and most meshers write): one read
            cnt_t, idx_t = _PLY_TYPES[props[0][1]], _PLY_TYPES[props[0][2]]
            tri = np.dtype([("cnt", cnt_t[0]), ("idx", idx_t[0], 3)])
            at = f.tell()
            data = f.read(tri.itemsize * count)
            if len(data) == tri.itemsize * count:
                rec = np.frombuffer(data, tri)
                if (rec["cnt"] == 3).all():
                    out["faces"] = rec["idx"].astype(np.int64).reshape(-1, 3)
                    continue
            f.seek(at)
        # rows with a list: parsed one by one, scalars and lists in order
        faces = []
        for _ in range(count):
            for p in props:
                if p[0] == "scalar":
                    f.read(_PLY_TYPES[p[1]][1])
                    continue
                cnt_t, idx_t = _PLY_TYPES[p[1]], _PLY_TYPES[p[2]]
                n = int(np.frombuffer(f.read(cnt_t[1]), cnt_t[0])[0])
                idx = np.frombuffer(f.read(idx_t[1] * n), idx_t[0]).astype(np.int64)
                if _is_face_list(name, props, p):
                    faces += _fan(n, idx)
        if name == "face":
            out["faces"] = np.array(faces, dtype=np.int64).reshape(-1, 3)


def _read_ascii_body(f, elements, out):
    for name, count, props in elements:
        rows = [f.readline().split() for _ in range(count)]
        if all(p[0] == "scalar" for p in props):
            names = [p[2] for p in props]
            arr = np.array(rows, dtype=np.float64).reshape(count, len(names))
            _collect_vertex_fields(name, {nm: arr[:, i] for i, nm in enumerate(names)},
                                   set(names), out)
            continue
        faces = []
        for tok in rows:
            at = 0
            for p in props:
                if p[0] == "scalar":
                    at += 1
                    continue
                n = int(tok[at])
                idx = [int(v) for v in tok[at + 1:at + 1 + n]]
                at += 1 + n
                if _is_face_list(name, props, p):
                    faces += _fan(n, idx)
        if name == "face":
            out["faces"] = np.array(faces, dtype=np.int64).reshape(-1, 3)


def _collect_vertex_fields(name, rec, fields, out):
    if name != "vertex":
        return

    def get(k):
        return np.asarray(rec[k], np.float64)

    out["verts"] = np.stack([get("x"), get("y"), get("z")], axis=-1)
    if {"red", "green", "blue"} <= fields:
        out["colors"] = np.stack([np.asarray(rec[k]) for k in ("red", "green", "blue")],
                                 axis=-1).astype(np.uint8)
    if {"nx", "ny", "nz"} <= fields:
        out["normals"] = np.stack([get("nx"), get("ny"), get("nz")], axis=-1)
