"""PyTorch port, mesh extraction: every module the extraction path runs
against the JAX package's, on the same inputs and (carried over by
params_from_jax) the same weights, on the CPU: the copies of the JAX
package's host code, the checkpoint layout, the meshers, the sweeps,
``extract_mesh`` and the CLI."""

import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neuralrecon_w_tpu.datasets import colmap as jax_colmap  # noqa: E402
from neuralrecon_w_tpu.datasets.phototourism import load_scene_config as jax_scene_config  # noqa: E402
from neuralrecon_w_tpu.extraction import mesh as jax_mesh  # noqa: E402
from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config  # noqa: E402
from neuralrecon_w_tpu.ops import isosurface as jax_iso  # noqa: E402
from neuralrecon_w_tpu.ops import voxel_grid as jax_vg  # noqa: E402
from neuralrecon_w_tpu.parallel import sweep as jax_sweep  # noqa: E402
from neuralrecon_w_tpu.tools import convert_torch_ckpt as jax_convert  # noqa: E402
from neuralrecon_w_tpu.utils import ply as jax_ply  # noqa: E402
from neuralrecon_w_tpu_torch.datasets import colmap  # noqa: E402
from neuralrecon_w_tpu_torch.datasets.phototourism import load_scene_config  # noqa: E402
from neuralrecon_w_tpu_torch.extraction import mesh  # noqa: E402
from neuralrecon_w_tpu_torch.ops import isosurface, voxel_grid  # noqa: E402
from neuralrecon_w_tpu_torch.parallel import sweep  # noqa: E402
from neuralrecon_w_tpu_torch.tools import convert  # noqa: E402
from neuralrecon_w_tpu_torch.training.checkpoint import load_field, save_checkpoint  # noqa: E402
from neuralrecon_w_tpu_torch.utils import ply  # noqa: E402
from test_torch_field_forward import make_pair, small_cfg  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the sweeps: f32 on both sides, the port's K1 / K6 plain versions against
# JAX's XLA field; only summation order differs (the gradient feeding the
# colour head is the JAX test's 1e-3, which moves rgb by far less)
SDF_ATOL, RGB_ATOL = 1e-5, 1e-4
# A vertex sits on its edge at s0 / (s0 - s1), so an SDF that differs by d
# (summation order, ~1e-7) moves it by d / |s0 - s1| of a cell: nearly every
# vertex stays within VERT_ATOL SFM units; the few on edges whose two SDF
# values nearly agree move further, but by no more than VERT_CELLS cells
VERT_ATOL, VERT_FRAC, VERT_CELLS = 1e-5, 0.999, 1e-3


def tree_equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(tree_equal(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b))


# ---------------- copies of the JAX package's host code ----------------


@pytest.mark.parametrize("encode_a_bg", [True, False])
def test_state_dict_converters_match_jax(encode_a_bg):
    cfg = small_cfg()
    cfg.NEUCONW.ENCODE_A_BG = encode_a_bg
    params, _, _ = make_pair(cfg)
    np_params = jax.tree.map(np.asarray, params)
    want, got = jax_convert.export_state_dict(np_params), convert.export_state_dict(np_params)
    assert list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype for k in want)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in want.items()}
    assert tree_equal(convert.convert_state_dict(sd), jax_convert.convert_state_dict(sd))
    assert tree_equal(convert.convert_state_dict(sd), np_params)


def test_points3d_io_cross_reads(tmp_path):
    """Each side reads the other's bytes, and both write the same bytes."""
    rng = np.random.default_rng(0)
    pts = {i: colmap.Point3D(i, rng.standard_normal(3), rng.integers(0, 255, 3).astype(np.uint8),
                             float(rng.uniform()), rng.integers(0, 9, i % 4 + 1).astype(np.int32),
                             rng.integers(0, 99, i % 4 + 1).astype(np.int32))
           for i in range(1, 40)}
    colmap.write_points3d_binary(pts, str(tmp_path / "port.bin"))
    jax_pts = {i: jax_colmap.Point3D(**vars(p)) for i, p in pts.items()}
    jax_colmap.write_points3d_binary(jax_pts, str(tmp_path / "jax.bin"))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    for read, path in ((jax_colmap.read_points3d_binary, "port.bin"),
                       (colmap.read_points3d_binary, "jax.bin")):
        back = read(str(tmp_path / path))
        assert list(back) == list(pts)
        for i, p in pts.items():
            q = back[i]
            assert q.id == p.id and q.error == p.error
            for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
                np.testing.assert_array_equal(getattr(q, f), getattr(p, f))


def test_load_scene_config_matches_jax(tmp_path):
    import chip_smoke as cs

    cs.write_workspace(str(tmp_path), np.zeros((3, 3)))
    assert load_scene_config(str(tmp_path)) == jax_scene_config(str(tmp_path))


def sphere_points(n=3000, seed=0):
    v = np.random.default_rng(seed).standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def rows(a):
    return a[np.lexsort(a.T[::-1])]


def test_voxel_grid_additions_match_jax():
    """grid_from_sfm_points through a rotated sfm2gt, its corners and its
    upsampling: the same cell sets (each side in its own order)."""
    c, s = np.cos(0.3), np.sin(0.3)
    sfm2gt = np.array([[c, -s, 0, 0.1], [s, c, 0, -0.2], [0, 0, 1, 0.05], [0, 0, 0, 1]])
    scene = {"eval_bbx": [[-1.2, -1.3, -1.1], [1.4, 1.2, 1.3]], "sfm2gt": sfm2gt.tolist()}
    np.testing.assert_array_equal(voxel_grid.scene_bbx_sfm(scene), jax_vg.scene_bbx_sfm(scene))
    track = np.arange(3, dtype=np.int32)
    p3d = {i + 1: colmap.Point3D(i + 1, p, np.zeros(3, np.uint8), 0.0, track[:1 + i % 3],
                                 track[:1 + i % 3]) for i, p in enumerate(sphere_points())}
    got = voxel_grid.grid_from_sfm_points(scene, p3d, 1, 0.2, expand=0)
    want = jax_vg.grid_from_sfm_points(scene, p3d, 1, 0.2, expand=0)
    assert (got.level, got.scale) == (want.level, want.scale) and len(got.coords) > 0
    np.testing.assert_array_equal(got.origin, want.origin)
    np.testing.assert_array_equal(rows(got.coords), rows(want.coords))
    np.testing.assert_array_equal(rows(got.corners_sfm()), rows(want.corners_sfm()))
    up, jup = got.upsample(got.level + 2), want.upsample(want.level + 2)
    assert up.level == jup.level and up.coords.dtype == np.int32
    np.testing.assert_array_equal(up.coords, rows(jup.coords))  # the port's order is this one


def test_write_ply_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    v, n = rng.standard_normal((50, 3)), rng.standard_normal((50, 3))
    c, f = rng.integers(0, 256, (50, 3)).astype(np.uint8), rng.integers(0, 50, (80, 3))
    ply.write_ply(str(tmp_path / "port.ply"), v, faces=f, colors=c, normals=n, comment="x")
    jax_ply.write_ply(str(tmp_path / "jax.ply"), v, faces=f, colors=c, normals=n, comment="x")
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    for read in (jax_ply.read_ply, ply.read_ply):
        back = read(str(tmp_path / "port.ply"))
        np.testing.assert_array_equal(back["verts"], v.astype(np.float32))
        np.testing.assert_array_equal(back["normals"], n.astype(np.float32))
        np.testing.assert_array_equal(back["colors"], c)
        np.testing.assert_array_equal(back["faces"], f)


# ------------------------------ the meshers ------------------------------


def random_field(dim=(14, 12, 13), seed=0, with_mask=True):
    rng = np.random.default_rng(seed)
    x = np.stack(np.meshgrid(*[np.linspace(-1, 1, d) for d in dim], indexing="ij"), -1)
    sdf = (np.linalg.norm(x, axis=-1) - 0.6 + 0.05 * rng.standard_normal(dim)).astype(np.float32)
    mask = rng.uniform(size=dim) > 0.05 if with_mask else None
    return sdf, mask


@pytest.mark.parametrize("with_mask", [False, True])
def test_numpy_mesher_matches_jax(with_mask):
    sdf, mask = random_field(with_mask=with_mask)
    v, f = isosurface.marching_tetrahedra(sdf, 0.0, mask)
    jv, jf = jax_iso.marching_tetrahedra(sdf, 0.0, mask)
    assert len(f) > 100
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(isosurface.vertex_normals(v, f), jax_iso.vertex_normals(jv, jf))


@pytest.mark.parametrize("with_mask", [False, True])
def test_native_mesher_matches_numpy(with_mask):
    """The same mesh up to the vertex order: each native vertex within 1e-6
    of one numpy vertex, one to one, and the faces, so relabelled, the same
    oriented triangles."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host mesher")
    from scipy.spatial import cKDTree

    from neuralrecon_w_tpu_torch.ops.native import marching_tetrahedra_native

    sdf, mask = random_field(seed=1, with_mask=with_mask)
    v, f = marching_tetrahedra_native(sdf, 0.0, mask, max_verts=64, max_faces=64)  # regrows
    nv, nf = isosurface.marching_tetrahedra(sdf, 0.0, mask)
    assert v.shape == nv.shape and f.shape == nf.shape and len(f) > 100
    dist, idx = cKDTree(nv).query(v)
    assert dist.max() <= 1e-6 and len(np.unique(idx)) == len(v)

    def canon(faces):  # rotate each triangle to start at its least index
        r = np.argmin(faces, axis=1)
        faces = np.stack([faces[np.arange(len(faces)), (r + k) % 3] for k in range(3)], 1)
        return rows(faces)

    np.testing.assert_array_equal(canon(idx[f]), canon(nf))


# ------------------------------ the sweeps ------------------------------


def test_sweep_stitches_exactly():
    """Several macro batches of a few chunks each, a ragged last chunk: a
    per-row function comes back exactly, in order."""
    x = np.random.default_rng(2).standard_normal((1000, 3)).astype(np.float32)
    got = sweep.sweep(lambda p: p[:, 0] * 2 + p[:, 1], 96, x, device="cpu", macro=256)
    np.testing.assert_array_equal(got, x[:, 0] * 2 + x[:, 1])


@pytest.mark.parametrize("encode_a", [True, False])
def test_sweeps_match_jax(encode_a):
    """N = 1000, chunk 96, macro batches of 192 points: the port's sweeps
    against JAX's XLA ones (use_fused=False), float32; a_index past the
    vocabulary is clamped on both sides."""
    cfg = small_cfg()
    cfg.NEUCONW.ENCODE_A = encode_a
    params, model, fc = make_pair(cfg, seed=3)
    jfc = jax_field_config(cfg)
    pts = (np.random.default_rng(3).standard_normal((1000, 3)) * 0.4).astype(np.float32)
    got = sweep.sharded_sdf_sweep(model, fc, pts, 96, "cpu", macro=200)
    want = jax_sweep.sharded_sdf_sweep(params, jfc, pts, None, 96, use_fused=False)
    np.testing.assert_allclose(got, want, atol=SDF_ATOL)
    view = np.array([0.0, 0.0, 1.0], np.float32)
    got = sweep.sharded_rgb_sweep(model, fc, pts, view, 1123, 96, "cpu", macro=200)
    want = jax_sweep.sharded_rgb_sweep(params, jfc, pts, view, 1123, None, 96, use_fused=False)
    assert got.shape == (1000, 3)
    np.testing.assert_allclose(got, want, atol=RGB_ATOL)


# ------------------------------ extract_mesh ------------------------------


def sparse_workspace(model, fc, root):
    """SFM points on the field's zero set at level 4 (the chip smoke's
    workspace at a small size), and its level-6 grid on both sides."""
    import chip_smoke as cs

    pts, _, _ = cs.zero_set_points(model, fc, 3000)
    assert len(pts) == 3000
    radius = cs.EXTRACT_REACH / float(np.linalg.norm(pts, axis=1).max())
    scene = cs.write_workspace(root, pts * radius, radius, sfm_voxel=0.1875)
    return scene, os.path.join(root, "dense", "sparse", "points3D.bin")


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_extract_mesh_matches_jax(tmp_path, kind):
    """With colours: the same faces, vertices within VERT_ATOL (VERT_FRAC
    of them; all within VERT_CELLS cells), colours within 1 uint8 level,
    normals alike."""
    params, model, fc = make_pair(small_cfg(), seed=4)
    jfc = jax_field_config(small_cfg())
    if kind == "dense":
        origin, radius = np.zeros(3), 2.0
        grid = mesh.dense_eval_grid(origin, radius, 48)
        jgrid = jax_mesh.dense_eval_grid(origin, radius, 48)
    else:
        scene, path = sparse_workspace(model, fc, str(tmp_path))
        origin, radius = np.asarray(scene["origin"], np.float64), float(scene["radius"])
        grid = mesh.sparse_eval_grid(scene, colmap.read_points3d_binary(path), 6)
        jgrid = jax_mesh.sparse_eval_grid(scene, jax_colmap.read_points3d_binary(path), 6)
        assert grid.dim == jgrid.dim == 64 and grid.voxel_size == jgrid.voxel_size
        np.testing.assert_array_equal(rows(grid.indices), rows(jgrid.indices))
        # the port's cell order differs; JAX sweeps the port's lattice too
        jgrid = jgrid._replace(points_sfm=grid.points_sfm, indices=grid.indices)
    got = mesh.extract_mesh(model, fc, grid, origin, radius, chunk=4096, with_color=True,
                            a_index=3, chunk_rgb=4096, device="cpu")
    want = jax_mesh.extract_mesh(params, jfc, jgrid, origin, radius, chunk=4096, with_color=True,
                                 a_index=3, chunk_rgb=4096)
    assert len(want.faces) > 100
    np.testing.assert_array_equal(got.faces, want.faces)
    err = np.abs(got.verts - want.verts).max(axis=1)
    assert (err <= VERT_ATOL).mean() >= VERT_FRAC
    assert err.max() <= VERT_CELLS * grid.voxel_size
    np.testing.assert_allclose(got.normals, want.normals, atol=1e-3)
    assert np.abs(got.colors.astype(int) - want.colors.astype(int)).max() <= 1


def test_checkpoint_round_trip(tmp_path):
    """save_checkpoint -> load_field gives the same field; what it saves is
    the JAX params under JAX's convert_state_dict, dead entries zero."""
    params, model, fc = make_pair(small_cfg(), seed=5)
    path = save_checkpoint(str(tmp_path / "ck" / "last.ckpt"), model, 7)
    back = load_field(path, fc, "cpu")
    assert all(torch.equal(v, back.state_dict()[k]) for k, v in model.state_dict().items())
    ckpt = torch.load(path, weights_only=False)
    assert ckpt["global_step"] == 7 and ckpt["epoch"] == 0
    sd = ckpt["state_dict"]
    want = jax_convert.export_state_dict(jax.tree.map(np.asarray, params))
    assert set(sd) == set(want) and all(tuple(sd[k].shape) == want[k].shape for k in want)
    assert float(sd["neuconw.xyz_encoding_final.weight"].abs().sum()) == 0.0
    assert tree_equal(jax_convert.convert_state_dict(sd), jax.tree.map(np.asarray, params))


def test_load_field_reads_the_jax_export(tmp_path):
    """A JAX checkpoint exported as convert_torch_ckpt --reverse writes it
    strict-loads into the port."""
    params, model, fc = make_pair(small_cfg(), seed=6)
    sd = jax_convert.export_state_dict(jax.tree.map(np.asarray, params))
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v, np.float32))
                               for k, v in sd.items()}, "global_step": 3, "epoch": 0},
               str(tmp_path / "x.ckpt"))
    back = load_field(str(tmp_path / "x.ckpt"), fc, "cpu")
    assert all(torch.equal(v, back.state_dict()[k]) for k, v in model.state_dict().items())


def test_cli_writes_the_ply(tmp_path):
    """extract_mesh_cli at a small width on a synthetic workspace, on the
    CPU: the ply where the JAX CLI names it, read back whole."""
    import chip_smoke as cs
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg
    from neuralrecon_w_tpu_torch.tools import extract_mesh_cli
    from neuralrecon_w_tpu_torch.models.neuconw import init_field

    extra = {"NEUCONW": {"SDF_CONFIG": {"d_hidden": 64, "d_out": 65, "n_layers": 4,
                                        "skip_in": [2]},
                         "COLOR_CONFIG": {"d_feature": 64, "d_hidden": 32, "n_layers": 2},
                         "N_VOCAB": 4}}
    cfg_path = cs.write_cfg(str(tmp_path / "c.yaml"), str(tmp_path), extra)
    fc = field_config_from_cfg(load_cfg(cfg_path))
    model = init_field(fc, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
    _, path = sparse_workspace(model, fc, str(tmp_path))
    ckpt = save_checkpoint(str(tmp_path / "results" / "checkpoints" / "last.ckpt"), model, 1)
    res = extract_mesh_cli.main(["--cfg_path", cfg_path, "--ckpt_path", ckpt, "--eval_level", "6",
                                 "--vertex_color", "--device", "cpu"])
    assert res.path == str(tmp_path / "results" / "extracted_mesh_level_6_colored.ply")
    back = ply.read_ply(res.path)
    assert len(back["faces"]) == len(res.mesh.faces) > 100
    np.testing.assert_array_equal(back["colors"], res.mesh.colors)
    assert set(res.seconds) == {"grid", "sdf sweep", "scatter", "marching", "normals",
                                "colour sweep", "ply write"}
