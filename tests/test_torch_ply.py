"""PyTorch port, PLY reader: the port's ``read_ply`` against the JAX
package's on the files other tools write (ASCII bodies, double and uint
properties, n-gon faces, extra elements) and on the port's own binary
layout. Equal keys, dtypes and arrays, exactly."""

import numpy as np
import pytest

from neuralrecon_w_tpu.utils.ply import read_ply as jax_read_ply
from neuralrecon_w_tpu_torch.utils.ply import read_ply, write_ply

RNG = np.random.default_rng(0)
VERTS = RNG.standard_normal((6, 3))
NORMALS = RNG.standard_normal((6, 3))
COLORS = RNG.integers(0, 256, (6, 3))
# a triangle, a quad and a pentagon: 1 + 2 + 3 triangles after the fan
POLYS = [[0, 1, 2], [2, 3, 4, 5], [5, 4, 3, 1, 0]]


def header(fmt, vprops, face_list=None, extra=None):
    lines = ["ply", f"format {fmt} 1.0", "comment written by the test", "element vertex 6"]
    lines += [f"property {t} {n}" for t, n in vprops]
    if extra is not None:
        lines += [f"element edge {len(extra)}", "property int vertex1", "property int vertex2"]
    if face_list is not None:
        lines += [f"element face {len(POLYS)}", f"property list {face_list} vertex_indices"]
    return ("\n".join(lines + ["end_header"]) + "\n").encode("ascii")


def ascii_ply(path):
    vprops = [("float", "x"), ("float", "y"), ("float", "z"), ("float", "nx"), ("float", "ny"),
              ("float", "nz"), ("uchar", "red"), ("uchar", "green"), ("uchar", "blue")]
    edges = [[0, 1], [2, 3]]
    with open(path, "wb") as f:
        f.write(header("ascii", vprops, "uchar int", extra=edges))
        for v, n, c in zip(VERTS, NORMALS, COLORS):
            f.write((" ".join(f"{x:.6f}" for x in (*v, *n)) + " "
                     + " ".join(str(int(x)) for x in c) + "\n").encode())
        for e in edges:
            f.write(f"{e[0]} {e[1]}\n".encode())
        for p in POLYS:
            f.write((" ".join(str(x) for x in [len(p), *p]) + "\n").encode())


def binary_ply(path, vtype="double", face_list="uchar uint", extra=True):
    vt = {"double": "<f8", "float": "<f4"}[vtype]
    vprops = [(vtype, "x"), (vtype, "y"), (vtype, "z"), ("uchar", "red"), ("uchar", "green"),
              ("uchar", "blue")]
    edges = np.array([[0, 1], [2, 3], [4, 5]], "<i4")
    cnt_t, idx_t = {"uchar uint": ("u1", "<u4"), "int int": ("<i4", "<i4"),
                    "uchar int": ("u1", "<i4")}[face_list]
    with open(path, "wb") as f:
        f.write(header("binary_little_endian", vprops, face_list,
                       extra=edges if extra else None))
        rec = np.empty(6, [("xyz", vt, 3), ("rgb", "u1", 3)])
        rec["xyz"], rec["rgb"] = VERTS, COLORS
        f.write(rec.tobytes())
        if extra:
            f.write(edges.tobytes())
        for p in POLYS:
            f.write(np.array([len(p)], cnt_t).tobytes() + np.array(p, idx_t).tobytes())


def assert_same(path):
    got, want = read_ply(path), jax_read_ply(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


def test_ascii_with_ngons_normals_colors_and_an_extra_element(tmp_path):
    path = str(tmp_path / "a.ply")
    ascii_ply(path)
    got = assert_same(path)
    assert got["faces"].shape == (6, 3)
    np.testing.assert_array_equal(got["faces"][1:3], [[2, 3, 4], [2, 4, 5]])
    assert set(got) == {"verts", "normals", "colors", "faces"}


@pytest.mark.parametrize("vtype,face_list", [("double", "uchar uint"), ("float", "int int"),
                                             ("float", "uchar int")])
def test_binary_scalar_types_and_face_lists(tmp_path, vtype, face_list):
    path = str(tmp_path / "b.ply")
    binary_ply(path, vtype, face_list)
    got = assert_same(path)
    np.testing.assert_array_equal(got["faces"][3:], [[5, 4, 3], [5, 3, 1], [5, 1, 0]])
    if vtype == "double":
        np.testing.assert_array_equal(got["verts"], VERTS)


def test_binary_triangles_only_and_the_port_round_trip(tmp_path):
    """The port's own layout (uchar int triangles, float vertices, normals,
    colours) reads back as written, the same as JAX's reader reads it."""
    path = str(tmp_path / "c.ply")
    faces = RNG.integers(0, 6, (9, 3))
    write_ply(path, VERTS, faces=faces, colors=COLORS, normals=NORMALS)
    got = assert_same(path)
    np.testing.assert_array_equal(got["faces"], faces)
    np.testing.assert_array_equal(got["verts"], VERTS.astype(np.float32))
    np.testing.assert_array_equal(got["colors"], COLORS.astype(np.uint8))
    # a point cloud: no face element
    write_ply(path, VERTS)
    assert set(assert_same(path)) == {"verts"}


def test_not_a_ply_raises(tmp_path):
    path = tmp_path / "x.ply"
    path.write_bytes(b"obj\n")
    with pytest.raises(ValueError):
        read_ply(str(path))
