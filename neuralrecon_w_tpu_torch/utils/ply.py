"""PLY mesh I/O: ``write_ply`` is the port's copy of
``neuralrecon_w_tpu/utils/ply.py:14-60`` and writes the
extracted mesh (binary little endian, float vertices and normals, uchar
colours, int face lists); ``read_ply`` reads that layout back, for the
tests and the chip smoke's checks."""

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


_PLY_TYPES = {"float": "<f4", "uchar": "u1"}
_FACE = np.dtype([("cnt", "u1"), ("idx", "<i4", 3)])


def read_ply(path: str) -> dict:
    """Read back what ``write_ply`` writes: 'verts' (V, 3) float64, and
    where the file has them 'normals' (V, 3) float64, 'colors' (V, 3)
    uint8 and 'faces' (F, 3) int64. Other layouts raise."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a ply file: {path}")
        props, counts = [], {}
        while (line := f.readline().decode("ascii").strip()) != "end_header":
            tok = line.split()
            if tok[0] == "format" and tok[1] != "binary_little_endian":
                raise ValueError(f"{path}: format {tok[1]}, not binary_little_endian")
            if tok[0] == "element":
                counts[tok[1]] = int(tok[2])
            elif tok[0] == "property" and tok[1] == "list":
                if tok[2:4] != ["uchar", "int"]:
                    raise ValueError(f"{path}: face list {tok[2:4]}, not uchar int")
            elif tok[0] == "property":
                props.append((tok[2], _PLY_TYPES[tok[1]]))
        vdt = np.dtype(props)
        rec = np.frombuffer(f.read(vdt.itemsize * counts["vertex"]), vdt)
        out = {"verts": np.stack([rec[k] for k in "xyz"], axis=-1).astype(np.float64)}
        if "nx" in vdt.names:
            out["normals"] = np.stack([rec[k] for k in ("nx", "ny", "nz")], axis=-1).astype(
                np.float64)
        if "red" in vdt.names:
            out["colors"] = np.stack([rec[k] for k in ("red", "green", "blue")], axis=-1)
        if "face" in counts:
            frec = np.frombuffer(f.read(_FACE.itemsize * counts["face"]), _FACE)
            if (frec["cnt"] != 3).any():
                raise ValueError(f"{path}: faces that are not triangles")
            out["faces"] = frec["idx"].astype(np.int64)
    return out
