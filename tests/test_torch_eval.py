"""PyTorch port, mesh evaluation: eval_mesh_arrays, eval_mesh (every
metrics.json it writes) and eval_mesh_cli against the JAX package's on the
same ply files, the empty-side cases, and the jet colourings."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

from neuralrecon_w_tpu import evaluation as jax_eval  # noqa: E402
from neuralrecon_w_tpu.ops.isosurface import marching_tetrahedra  # noqa: E402
from neuralrecon_w_tpu.testing import make_synthetic_scene  # noqa: E402
from neuralrecon_w_tpu.training.validation import visualize_depth as jax_vis_depth  # noqa: E402
from neuralrecon_w_tpu.utils.ply import write_ply  # noqa: E402
from neuralrecon_w_tpu_torch import evaluation  # noqa: E402
from neuralrecon_w_tpu_torch.training.validation import visualize_depth  # noqa: E402

RTOL = 1e-6  # every metric


@pytest.fixture(scope="module")
def plys(tmp_path_factory):
    """A sphere mesh (pred) and a noisy point cloud of a shifted sphere
    (gt), as ply files."""
    base = tmp_path_factory.mktemp("eval")
    dim = 32
    ax = np.linspace(-1, 1, dim)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    verts, faces = marching_tetrahedra(np.linalg.norm(g, axis=-1) - 0.6)
    verts = verts * (2.0 / (dim - 1)) - 1.0
    rng = np.random.RandomState(0)
    gt = rng.randn(3000, 3)
    gt = gt / np.linalg.norm(gt, axis=-1, keepdims=True) * 0.62 + [0.03, 0.0, -0.02]
    pred, trgt = str(base / "pred.ply"), str(base / "gt.ply")
    write_ply(pred, verts, faces=faces)
    write_ply(trgt, gt + rng.randn(*gt.shape) * 0.002)
    return pred, trgt, str(base)


def assert_metrics_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), rtol=RTOL, atol=0, err_msg=k)


def metric_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f == "metrics.json")


def test_eval_mesh_arrays_matches_jax():
    rng = np.random.default_rng(0)
    pred, gt = rng.standard_normal((700, 3)), rng.standard_normal((900, 3)) * 1.1
    for th in (0.05, 0.1, 0.5):
        assert_metrics_equal(evaluation.eval_mesh_arrays(pred, gt, th),
                             jax_eval.eval_mesh_arrays(pred, gt, th))


@pytest.mark.parametrize("bbx", [None, [[-0.5, -1, -1], [1, 1, 1]]])
def test_eval_mesh_matches_jax(plys, tmp_path, bbx):
    """The returned metrics and every metrics.json file, the visualisation
    plys written where JAX writes them."""
    pred, trgt, _ = plys
    sc = {"eval_bbx": bbx or [[-1, -1, -1], [1, 1, 1]], "sfm2gt": np.eye(4).tolist()}
    th = [0.01, 0.02, 0.05]
    got = evaluation.eval_mesh(pred, trgt, sc, threshold=th, save_dir=str(tmp_path / "p"))
    want = jax_eval.eval_mesh(pred, trgt, sc, threshold=th, save_dir=str(tmp_path / "j"))
    assert_metrics_equal(got, want)
    assert 0.05 < got["fscores"][1] < 0.99
    files = metric_files(tmp_path / "j")
    assert metric_files(tmp_path / "p") == files and len(files) == 4
    for rel in files:
        with open(tmp_path / "p" / rel) as f1, open(tmp_path / "j" / rel) as f2:
            assert_metrics_equal(json.load(f1), json.load(f2))
    plies = sorted(p for p in os.listdir(tmp_path / "j" / "visualize" / "0.02"))
    assert sorted(os.listdir(tmp_path / "p" / "visualize" / "0.02")) == plies


def test_eval_mesh_cli_matches_jax(plys, tmp_path):
    """eval_mesh_cli with the SFM-voxel crop (--sfm_path) and a threshold
    sweep: metrics.json equal."""
    from neuralrecon_w_tpu.tools.eval_mesh_cli import main as jax_main
    from neuralrecon_w_tpu_torch.tools.eval_mesh_cli import main

    pred, trgt, _ = plys
    root = str(tmp_path / "scene")
    os.makedirs(root)
    make_synthetic_scene(root, n_images=6, n_test=1, img_wh=(40, 30), sphere_radius=0.62,
                         n_points=600)
    argv = ["--file_pred", pred, "--file_trgt", trgt, "--scene_config",
            os.path.join(root, "config.yaml"), "--threshold_start", "0.01",
            "--threshold_end", "0.05", "--threshold_interval", "0.02",
            "--sfm_path", os.path.join(root, "dense", "sparse"), "--track_length", "1",
            "--error", "2", "--voxel_size", "0.1"]
    got = main(argv + ["--save_name", "port"])
    want = jax_main(argv + ["--save_name", "jax"])
    assert_metrics_equal(got, want)
    base = os.path.dirname(pred)
    with open(os.path.join(base, "eval_port", "metrics.json")) as f1, \
            open(os.path.join(base, "eval_jax", "metrics.json")) as f2:
        assert_metrics_equal(json.load(f1), json.load(f2))


def test_empty_sides_score_zero_not_nan(plys, tmp_path):
    """tests/test_extraction_eval.py:147's cases: an empty distance set and
    a prediction cropped away entirely score the 1e-6 floor and an infinite
    chamfer, as the JAX package's do."""
    got = evaluation.compute_prf(np.zeros(0), np.zeros(0), 0.1)
    assert_metrics_equal(got, jax_eval.compute_prf(np.zeros(0), np.zeros(0), 0.1))
    assert got["fscore"] == pytest.approx(1e-6)
    assert got["dist1"] == float("inf") and got["dist2"] == float("inf")
    assert not any(np.isnan(v) for v in got.values())
    pred, trgt, _ = plys
    sc = {"eval_bbx": [[5, 5, 5], [6, 6, 6]], "sfm2gt": np.eye(4).tolist()}
    got = evaluation.eval_mesh(pred, trgt, sc, threshold=0.1, save_dir=str(tmp_path / "p"))
    want = jax_eval.eval_mesh(pred, trgt, sc, threshold=0.1, save_dir=str(tmp_path / "j"))
    assert got == want
    assert got["chamfer_pred_to_gt"] == float("inf")


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.2, 1.2, (2000, 3))
    bbx = [[-1, -0.5, -1], [1, 1, 0.8]]
    np.testing.assert_array_equal(evaluation.bbx_crop(pts, bbx), jax_eval.bbx_crop(pts, bbx))
    m = np.eye(4)
    m[:3, :3] *= 1.7
    m[:3, 3] = [0.1, 0.2, -0.3]
    np.testing.assert_array_equal(evaluation.transform_points(pts, m),
                                  jax_eval.transform_points(pts, m))
    vox = pts[:100]
    np.testing.assert_array_equal(evaluation.voxel_point_crop(pts, vox, 0.1, bbx),
                                  jax_eval.voxel_point_crop(pts, vox, 0.1, bbx))
    for a, b in zip(evaluation.nn_distances(pts[:500], pts[500:]),
                    jax_eval.nn_distances(pts[:500], pts[500:])):
        np.testing.assert_array_equal(a, b)
    d = np.abs(rng.standard_normal(1000)) * 0.2
    np.testing.assert_array_equal(evaluation.error_colormap(d, 0.05),
                                  jax_eval.error_colormap(d, 0.05))


def test_visualize_depth_matches_jax():
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.5, 4.0, (30, 40))
    depth[:3] = 0.0
    depth[5, 5] = np.nan
    np.testing.assert_array_equal(visualize_depth(depth), jax_vis_depth(depth))
    np.testing.assert_array_equal(visualize_depth(np.zeros((4, 4))),
                                  jax_vis_depth(np.zeros((4, 4))))
