"""PyTorch port, the data slice: the synthetic workspace, COLMAP binaries,
scene metadata, per-image rays, the voxel near / far filter, the ray cache
and its split assignment, each against the JAX package's on the same
seeded inputs."""

import filecmp
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neuralrecon_w_tpu.datasets import cache as jax_cache  # noqa: E402
from neuralrecon_w_tpu.datasets import colmap as jax_colmap  # noqa: E402
from neuralrecon_w_tpu.datasets import phototourism as jax_pt  # noqa: E402
from neuralrecon_w_tpu.testing import make_synthetic_scene as jax_make_scene  # noqa: E402
from neuralrecon_w_tpu_torch.datasets import cache, colmap, phototourism  # noqa: E402
from neuralrecon_w_tpu_torch.datasets.rays import get_ndc_rays  # noqa: E402
from neuralrecon_w_tpu_torch.testing import make_synthetic_scene  # noqa: E402

torch.set_num_threads(1)

ROWS_ATOL = 1e-6  # build_image_rays / sfm_depth_raster / oversampled rows
NEAR_FAR_ATOL = 1e-5  # apply_voxel_near_far
SCENE = dict(n_images=6, n_test=1, img_wh=(40, 30))  # tests/test_e2e.py's fixture


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same workspace written by each package (same seed, same args)."""
    out = {}
    for name, make in (("jax", jax_make_scene), ("port", make_synthetic_scene)):
        root = str(tmp_path_factory.mktemp(name) / "sphere_scene")
        os.makedirs(root)
        make(root, **SCENE)
        out[name] = root
    return out


def workspace_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_synthetic_workspace_matches_jax(scenes):
    """Same file list; the COLMAP bytes, the tsv and config.yaml byte-equal;
    images equal within 1 level; semantic maps equal."""
    from PIL import Image

    j, p = scenes["jax"], scenes["port"]
    files = workspace_files(j)
    assert workspace_files(p) == files
    for rel in files:
        a, b = os.path.join(j, rel), os.path.join(p, rel)
        if rel.endswith((".bin", ".tsv", ".yaml")):
            assert filecmp.cmp(a, b, shallow=False), rel
        elif rel.endswith(".jpg"):
            diff = np.abs(np.asarray(Image.open(a), np.int32) - np.asarray(Image.open(b), np.int32))
            assert diff.max() <= 1, rel
        elif rel.endswith(".npz"):
            np.testing.assert_array_equal(np.load(a)["arr_0"], np.load(b)["arr_0"])


@pytest.mark.parametrize("name", ["cameras", "images", "points3D"])
def test_colmap_round_trip_bytes(scenes, tmp_path, name):
    """The port reads what the JAX package wrote to the same records and
    writes them back byte for byte."""
    src = os.path.join(scenes["jax"], "dense", "sparse", f"{name}.bin")
    reader = {"cameras": "read_cameras_binary", "images": "read_images_binary",
              "points3D": "read_points3d_binary"}[name]
    got = getattr(colmap, reader)(src)
    want = getattr(jax_colmap, reader)(src)
    assert got.keys() == want.keys()
    for k in got:
        for field in want[k].__dataclass_fields__:
            np.testing.assert_array_equal(np.asarray(getattr(got[k], field)),
                                          np.asarray(getattr(want[k], field)))
    out = str(tmp_path / f"{name}.bin")
    getattr(colmap, reader.replace("read", "write"))(got, out)
    assert filecmp.cmp(src, out, shallow=False)


def test_quaternions_and_points3d_arrays(scenes):
    rng = np.random.default_rng(0)
    for _ in range(8):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        R = colmap.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jax_colmap.qvec2rotmat(q))
        np.testing.assert_array_equal(colmap.rotmat2qvec(R), jax_colmap.rotmat2qvec(R))
    src = os.path.join(scenes["jax"], "dense", "sparse", "points3D.bin")
    for a, b in zip(colmap.points3d_arrays(colmap.read_points3d_binary(src)),
                    jax_colmap.points3d_arrays(jax_colmap.read_points3d_binary(src))):
        np.testing.assert_array_equal(a, b)


def test_ndc_rays_match_jax():
    from neuralrecon_w_tpu.datasets.rays import get_ndc_rays as jax_ndc

    rng = np.random.default_rng(1)
    o = rng.standard_normal((16, 3))
    d = rng.standard_normal((16, 3))
    for a, b in zip(get_ndc_rays(30, 40, 32.0, 1.0, o, d), jax_ndc(30, 40, 32.0, 1.0, o, d)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("downscale", [1, 2])
def test_load_scene_meta_matches_jax(scenes, downscale):
    got = phototourism.load_scene_meta(scenes["jax"], downscale)
    want = jax_pt.load_scene_meta(scenes["jax"], downscale)
    for field in ("sfm_path", "scene_config", "img_ids", "img_ids_train", "img_ids_test",
                  "image_paths", "img_downscale"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("Ks", "poses", "w2c", "nears", "fars"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.fixture(scope="module")
def metas(scenes):
    return (phototourism.load_scene_meta(scenes["jax"]), jax_pt.load_scene_meta(scenes["jax"]))


@pytest.mark.parametrize("with_semantics", [True, False])
def test_build_image_rays_matches_jax(metas, with_semantics):
    meta, jmeta = metas
    for id_ in jmeta.img_ids:
        rays, rgbs = phototourism.build_image_rays(meta, id_, with_semantics=with_semantics)
        jrays, jrgbs = jax_pt.build_image_rays(jmeta, id_, with_semantics=with_semantics)
        assert rays.shape == jrays.shape and rays.dtype == jrays.dtype
        np.testing.assert_allclose(rays, jrays, rtol=0, atol=ROWS_ATOL)
        np.testing.assert_array_equal(rgbs, jrgbs)
        dm, wm = phototourism.sfm_depth_raster(meta, id_, 40, 30)
        jdm, jwm = jax_pt.sfm_depth_raster(jmeta, id_, 40, 30)
        np.testing.assert_allclose(dm, jdm, rtol=0, atol=ROWS_ATOL)
        np.testing.assert_allclose(wm, jwm, rtol=0, atol=ROWS_ATOL)
        assert (wm > 0).sum() > 0


def test_oversample_depth_rays_matches_jax(metas):
    meta, jmeta = metas
    id_ = jmeta.img_ids_train[0]
    rays, rgbs = jax_pt.build_image_rays(jmeta, id_)
    for pct in (0.0, 0.2, 0.4):
        got = phototourism.oversample_depth_rays(rays, rgbs, pct, np.random.RandomState(0))
        want = jax_pt.oversample_depth_rays(rays, rgbs, pct, np.random.RandomState(0))
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=ROWS_ATOL)


@pytest.mark.parametrize("voxel_size", [None, 0.06])
def test_apply_voxel_near_far_matches_jax(scenes, tmp_path, voxel_size):
    """Near / far within NEAR_FAR_ATOL and the same rays kept, at the
    fixture's voxel size (SFM grid level 3) and at a finer one (level 5)."""
    import yaml

    root = scenes["jax"]
    if voxel_size is not None:
        import shutil

        root = str(tmp_path / "fine")
        shutil.copytree(scenes["jax"], root)
        path = os.path.join(root, "config.yaml")
        sc = yaml.safe_load(open(path))
        sc["voxel_size"] = voxel_size
        yaml.safe_dump(sc, open(path, "w"))
    meta, jmeta = phototourism.load_scene_meta(root), jax_pt.load_scene_meta(root)
    kept = 0
    for id_ in jmeta.img_ids:
        rays, rgbs = jax_pt.build_image_rays(jmeta, id_)
        got_r, got_c = phototourism.apply_voxel_near_far(rays, rgbs, meta, chunk=512,
                                                         device="cpu")
        want_r, want_c = jax_pt.apply_voxel_near_far(rays, rgbs, jmeta, chunk=512)
        assert got_r.shape == want_r.shape
        np.testing.assert_array_equal(got_r[:, [0, 1, 2, 3, 4, 5, 8, 9, 10, 11]],
                                      want_r[:, [0, 1, 2, 3, 4, 5, 8, 9, 10, 11]])
        np.testing.assert_allclose(got_r[:, 6:8], want_r[:, 6:8], rtol=0, atol=NEAR_FAR_ATOL)
        np.testing.assert_array_equal(got_c, want_c)
        kept += len(got_r)
    assert 0 < kept


def per_image(meta):
    rays, rgbs = [], []
    for id_ in meta.img_ids_train:
        r, c = jax_pt.build_image_rays(meta, id_)
        rays.append(r)
        rgbs.append(c)
    return rays, rgbs


@pytest.mark.parametrize("cache_type", ["h5", "npz"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ray_cache_cross_read(metas, tmp_path, cache_type, writer):
    """A cache written by one package reads back equal in the other, and
    both writers write the same splits and meta info."""
    _, jmeta = metas
    rays, rgbs = per_image(jmeta)
    roots = {}
    for name, mod in (("port", cache), ("jax", jax_cache)):
        roots[name] = mod.write_ray_cache(rays, rgbs, str(tmp_path / name), n_splits=8,
                                          cache_type=cache_type)
    reader = jax_cache if writer == "port" else cache
    other = cache if writer == "port" else jax_cache
    got = reader.read_ray_cache(roots[writer])
    want = other.read_ray_cache(roots[writer])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    theirs = (jax_cache if writer == "port" else cache).read_ray_cache(
        roots["jax" if writer == "port" else "port"])
    for a, b in zip(got, theirs):
        np.testing.assert_array_equal(a, b)
    with open(os.path.join(roots["port"], "rays1_meta_info.json")) as f1, \
            open(os.path.join(roots["jax"], "rays1_meta_info.json")) as f2:
        assert f1.read() == f2.read()
    names = ["split_3", "split_0"]
    for a, b in zip(cache.read_ray_cache(roots[writer], names),
                    jax_cache.read_ray_cache(roots[writer], names)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world_size", [1, 2, 3, 5, 8])
def test_local_split_names_match_jax(tmp_path, world_size):
    root = tmp_path / "splits"
    for i in range(8):
        (root / f"split_{i}").mkdir(parents=True)
    shares = [cache.local_split_names(str(root), world_size, r) for r in range(world_size)]
    assert shares == [jax_cache.local_split_names(str(root), world_size, r)
                      for r in range(world_size)]
    assert sorted(sum(shares, [])) == sorted(os.listdir(root))
    with pytest.raises(ValueError):
        cache.local_split_names(str(root), 9, 0)
