"""PyTorch port, the geometry-evaluation path: the reprojection filter in
both modes, its depth rasteriser, its CLI, the reprojection-error audit and
the metric plots, each against the JAX package on the same inputs.

Cells are linear indices in the port and Morton codes in JAX, so the
tests compare what leaves the module: the cells as sets (decoded), the keep
masks and the kept vertices and faces, exactly; depths within 1e-5
(float32 entry depths of the two DDAs) or exactly (the rasterisers)."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neuralrecon_w_tpu.evaluation import reproj_filter as jrf  # noqa: E402
from neuralrecon_w_tpu.ops import ray_voxel as jrv  # noqa: E402
from neuralrecon_w_tpu.ops.morton import morton_to_points  # noqa: E402
from neuralrecon_w_tpu_torch.evaluation import reproj_filter as trf  # noqa: E402
from neuralrecon_w_tpu_torch.ops import ray_voxel as trv  # noqa: E402
from neuralrecon_w_tpu_torch.ops.voxel_grid import _from_linear  # noqa: E402

torch.set_num_threads(1)


def ring_cameras(n=6, dist=4.0, K=None, wh=(48, 36), z=0.0):
    """tests/test_extraction_eval.py's camera ring (right-up-back c2w)."""
    if K is None:
        K = np.array([[40.0, 0, 24], [0, 40.0, 18], [0, 0, 1]])
    cameras = []
    for ang in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = np.array([np.cos(ang) * dist, np.sin(ang) * dist, z])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        down = np.cross(fwd, right)
        c2w = np.concatenate([np.stack([right, -down, -fwd], axis=1), eye[:, None]], axis=1)
        cameras.append((K, c2w, wh))
    return cameras


def sphere_points(n, r=1.0, seed=3):
    v = np.random.RandomState(seed).randn(n, 3)
    return v / np.linalg.norm(v, axis=-1, keepdims=True) * r


def sphere_mesh(dim=24, r=0.6):
    from neuralrecon_w_tpu.ops.isosurface import marching_tetrahedra

    ax = np.linspace(-1, 1, dim)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    verts, faces = marching_tetrahedra(np.linalg.norm(g, axis=-1) - r)
    return verts * (2.0 / (dim - 1)) - 1.0, faces


def cell_set(codes, grid, morton):
    cells = morton_to_points(codes) if morton else _from_linear(codes, grid.level)
    return {tuple(c) for c in np.asarray(cells).tolist()}


@pytest.mark.parametrize("voxel", [0.15, 0.0002])
def test_voxelize_points_matches_jax(voxel):
    """The same level (capped at 12), cube and cells."""
    pts = sphere_points(800, seed=1) + np.array([0.3, -0.1, 0.2])
    want, got = jrf.voxelize_points(pts, voxel), trf.voxelize_points(pts, voxel)
    assert (got.level, got.scale) == (want.level, want.scale)
    assert got.level == (12 if voxel < 0.01 else want.level)
    np.testing.assert_array_equal(got.origin, want.origin)
    assert {tuple(c) for c in got.coords.tolist()} == {tuple(c) for c in want.coords.tolist()}


# a flat level-3 grid; a level-6 one as two levels; a level-9 one, two
# levels by default
GRIDS = [(0.15, None), (0.03, True), (0.003, None)]


@pytest.mark.parametrize("voxel,hier", GRIDS)
def test_hit_codes_and_keep_masks_match_jax(voxel, hier):
    """render_hit_codes per view and render_hit_codes_multi (chunk 4000:
    several flushes, a padded tail) hit the same cells as JAX's, and the
    vertices' keep masks are equal."""
    surf = sphere_points(500, seed=7)
    verts = np.concatenate([surf, np.zeros((3, 3))])
    jg, tg = jrf.voxelize_points(verts, voxel), trf.voxelize_points(verts, voxel)
    jd, td = jrv.make_device_grid(jg, hier), trv.make_device_grid(tg, hier, device="cpu")
    assert isinstance(td, trv.HierGrid) == (hier or tg.level >= 9) == isinstance(jd, jrv.HierGrid)
    cams = ring_cameras(7, z=0.5)
    for K, c2w, wh in cams[:2]:
        want = cell_set(jrf.render_hit_codes(jd, jg, K, c2w, wh), jg, True)
        assert cell_set(trf.render_hit_codes(td, tg, K, c2w, wh), tg, False) == want
    want = jrf.render_hit_codes_multi(jd, jg, cams, chunk=4000)
    stats = {}
    got = trf.render_hit_codes_multi(td, tg, cams, chunk=4000, stats=stats)
    assert cell_set(got, tg, False) == cell_set(want, jg, True)
    assert stats["dda_calls"] == 5 and stats["dda_rays"] == 20000  # flushes of 3, 3, 1 views
    keep_want = np.isin(jrf.vertex_voxel_codes(jg, verts), want)
    keep_got = np.isin(trf.vertex_voxel_codes(tg, verts), got)
    np.testing.assert_array_equal(keep_got, keep_want)
    # a level-9 grid of 500 points is sparse: few pixel rays find a cell
    assert keep_got[:500].mean() > (0.5 if tg.level < 9 else 0.0)


@pytest.mark.parametrize("voxel,hier", GRIDS[:2])
def test_voxel_depth_map_matches_jax(voxel, hier):
    surf = sphere_points(2000, seed=7)
    jg, tg = jrf.voxelize_points(surf, voxel), trf.voxelize_points(surf, voxel)
    K, c2w, wh = ring_cameras(1)[0]
    want = jrf.voxel_depth_map(jrv.make_device_grid(jg, hier), jg, K, c2w, wh)
    got = trf.voxel_depth_map(trv.make_device_grid(tg, hier, "cpu"), tg, K, c2w, wh)
    assert got.shape == want.shape == (36, 48) and (got > 0).sum() > 100
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_rasterizers_match_jax_and_each_other():
    """The numpy rasteriser equals JAX's exactly; the native one equals
    JAX's native one and the numpy one but for pixels on a triangle's edge,
    whose inclusion flips with the compiler's FMA contraction (JAX's
    library builds with -march=native): tests/test_extraction_eval.py:285's
    bound."""
    from neuralrecon_w_tpu.ops.native import rasterize_depth_native as jax_native
    from neuralrecon_w_tpu_torch.ops.native import rasterize_depth_native

    verts, faces = sphere_mesh(dim=16)
    K, c2w, wh = ring_cameras(1)[0]
    d_numpy = trf._rasterize_depth_numpy(verts, faces, c2w, K, wh[0], wh[1])
    np.testing.assert_array_equal(
        d_numpy, jrf._rasterize_depth_numpy(verts, faces, c2w, K, wh[0], wh[1]))
    d_native = rasterize_depth_native(verts, faces, c2w, K, wh[0], wh[1])
    assert d_native.dtype == np.float32 and d_native.shape == (36, 48)
    for other in (d_numpy, jax_native(verts, faces, c2w, K, wh[0], wh[1])):
        if other is None:  # the JAX package's library is not built
            continue
        disagree = np.abs(d_native - other) > 1e-4
        assert disagree.sum() <= max(3, int(0.002 * d_native.size)), disagree.sum()
    assert ((d_native > 0) & (d_numpy > 0)).sum() > 20


def test_native_rasteriser_clips_the_near_plane():
    """A triangle crossing z = znear is clipped and drawn where the numpy
    one drops it."""
    from neuralrecon_w_tpu_torch.ops.native import rasterize_depth_native

    K = np.array([[20.0, 0, 16], [0, 20.0, 12], [0, 0, 1]])
    c2w = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)  # looks down -z
    verts = np.array([[-1.0, -1.0, -2.0], [1.0, -1.0, -2.0], [0.0, 1.0, 0.5]])
    faces = np.array([[0, 1, 2]])
    d = rasterize_depth_native(verts, faces, c2w, K, 32, 24)
    assert (d > 0).sum() > 20 and not trf._rasterize_depth_numpy(
        verts, faces, c2w, K, 32, 24).any()


def test_mesh_depth_map_matches_analytic_sphere():
    verts, faces = sphere_mesh()
    K, c2w, wh = ring_cameras(1)[0]
    depth = trf.mesh_depth_map(verts, faces, K, c2w, wh)
    assert depth.shape == (36, 48)
    assert abs(depth[int(K[1, 2]), int(K[0, 2])] - (4.0 - 0.6)) < 0.08
    assert depth[0, 0] == 0.0 and depth[-1, -1] == 0.0
    assert 0.02 < (depth > 0).mean() < 0.5
    disagree = np.abs(depth - jrf.mesh_depth_map(verts, faces, K, c2w, wh)) > 1e-4
    assert disagree.sum() <= max(3, int(0.002 * depth.size)), disagree.sum()


@pytest.mark.parametrize("voxel", [0.15, 0.003])
def test_point_cloud_filter_matches_jax(voxel):
    """Point-cloud mode on a flat level-3 grid and a two-level level-9 one:
    JAX's keep mask and kept vertices; on the level-3 shell, which has no
    gaps, the occluded centre points drop (tests/test_extraction_eval.py:195)."""
    verts = np.concatenate([sphere_points(600, seed=3), np.zeros((5, 3))])
    cams = ring_cameras(6)
    want = jrf.reprojection_filter(verts, None, cams, voxel_size=voxel)
    stats = {}
    got = trf.reprojection_filter(verts, None, cams, voxel_size=voxel, device="cpu",
                                  stats=stats)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] is None and want[1] is None and got[2][:600].any()
    if stats["level"] < 9:
        assert got[2][:600].mean() > 0.5 and not got[2][600:].any()
    assert stats["level"] == (3 if voxel > 0.01 else 9)
    assert {"voxelize_s", "grid_s", "dda_s", "quantise_s", "isin_s"} <= set(stats)


@pytest.mark.parametrize("workers", [0, 3])
def test_mesh_filter_matches_jax(workers):
    """Mesh mode, serial and on a thread pool: JAX's keep mask, kept
    vertices and remapped faces; with a target set, the interior drops."""
    verts, faces = sphere_mesh(dim=16)
    K = np.array([[160.0, 0, 96], [0, 160.0, 72], [0, 0, 1]])
    cams = ring_cameras(4, K=K, wh=(192, 144))
    want = jrf.reprojection_filter(verts, faces, cams, voxel_size=0.02, workers=workers)
    got = trf.reprojection_filter(verts, faces, cams, voxel_size=0.02, workers=workers)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].mean() > 0.7 and got[1].max() < len(got[0])
    target = np.concatenate([verts, np.zeros((5, 3))])
    kept, kept_faces, mask = trf.reprojection_filter(verts, faces, cams, 0.02,
                                                     target_verts=target)
    assert kept_faces is None and not mask[len(verts):].any()
    np.testing.assert_array_equal(
        mask, jrf.reprojection_filter(verts, faces, cams, 0.02, target_verts=target)[2])


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The JAX package's synthetic workspace (6 views of 40x30 around a
    sphere of radius 1), a point cloud and a mesh of that sphere, and a GT
    scan of it."""
    from neuralrecon_w_tpu.testing import make_synthetic_scene
    from neuralrecon_w_tpu_torch.utils.ply import write_ply

    root = str(tmp_path_factory.mktemp("ws") / "scene")
    make_synthetic_scene(root, n_images=6, n_test=1, img_wh=(40, 30), n_points=300)
    cloud = os.path.join(root, "cloud.ply")
    pts = np.concatenate([sphere_points(1500, seed=5), np.zeros((4, 3))])
    colors = np.random.default_rng(0).integers(0, 256, (len(pts), 3))
    write_ply(cloud, pts, colors=colors)
    mesh = os.path.join(root, "mesh.ply")
    v, f = sphere_mesh(dim=20, r=0.6)
    write_ply(mesh, v / 0.6, faces=f)
    gt = os.path.join(root, "gt.ply")
    write_ply(gt, sphere_points(4000, seed=9))
    return root, cloud, mesh, gt


@pytest.mark.parametrize("kind", ["cloud", "mesh"])
def test_reproj_filter_cli_matches_jax(workspace, tmp_path, kind, capsys):
    from neuralrecon_w_tpu.tools import reproj_filter_cli as jcli
    from neuralrecon_w_tpu_torch.tools import reproj_filter_cli as tcli
    from neuralrecon_w_tpu_torch.utils.ply import read_ply

    root, cloud, mesh, _ = workspace
    src = cloud if kind == "cloud" else mesh
    args = ["--src_file", src, "--root_dir", root, "--img_downscale", "1", "--voxel_size",
            "0.02"]
    want = read_ply(jcli.main(args + ["--out_dir", str(tmp_path / "jax")]))
    got = read_ply(tcli.main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 0 < len(got["verts"]) < len(read_ply(src)["verts"])
    stages = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("stages ")]
    assert len(stages) == 1 and json.loads(stages[0][len("stages "):])


def test_reproj_error_matches_jax(workspace, tmp_path):
    from neuralrecon_w_tpu.tools import reproj_error as jre
    from neuralrecon_w_tpu_torch.tools import reproj_error as tre

    root, _, _, gt = workspace
    want = jre.main(["--root_dir", root, "--gt_ply", gt, "--track_length", "2"])
    out = str(tmp_path / "err.json")
    got = tre.main(["--root_dir", root, "--gt_ply", gt, "--track_length", "2", "--out", out])
    assert got == want and got["n_observations"] > 0
    with open(out) as f:
        assert json.load(f) == want
    K = np.array([[30.0, 0, 20], [0, 30.0, 15], [0, 0, 1]])
    w2c = np.concatenate([np.eye(3), [[0.1], [0.0], [3.0]]], axis=1)
    pts = np.random.default_rng(1).standard_normal((5, 3))
    np.testing.assert_array_equal(tre.project(K, w2c, pts), jre.project(K, w2c, pts))


def test_vis_results_writes_what_jax_writes(tmp_path):
    pytest.importorskip("matplotlib")
    from neuralrecon_w_tpu.evaluation import vis_results as jax_vis
    from neuralrecon_w_tpu_torch.tools import vis_metrics_cli

    th = [0.1, 0.2, 0.3, 0.4]
    for name, scale in (("ours", 1.0), ("colmap", 0.7)):
        os.makedirs(tmp_path / name)
        with open(tmp_path / name / "metrics.json", "w") as f:
            json.dump({"thresholds": th, "fscores": [scale * t for t in th],
                       "precs": [scale * 0.5] * 4, "recals": [scale * 0.9] * 4}, f)
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)
        got = vis_metrics_cli.main(["--ours_path", "ours", "--colmap_path", "colmap",
                                    "--save_name", "cmp", "--max_num", "3"])
        want = jax_vis("ours", "colmap", "cmp_jax", 3)
    finally:
        os.chdir(cwd)
    names = sorted(os.listdir(tmp_path / got))
    assert names == sorted(os.listdir(tmp_path / want)) == ["fscores.png", "precs.png",
                                                            "recals.png"]
    for n in names:
        assert (tmp_path / got / n).read_bytes() == (tmp_path / want / n).read_bytes()
