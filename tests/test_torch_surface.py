"""PyTorch port, the surface refresh: surface_level, the voxel-grid
helpers the refresh uses, octree_update on weights carried across from
the JAX package (the same cells kept), and the degeneracy warning."""

import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neuralrecon_w_tpu.ops import voxel_grid as jax_vg  # noqa: E402
from neuralrecon_w_tpu.parallel import sweep as jax_sweep  # noqa: E402
from neuralrecon_w_tpu.training import surface as jax_surface  # noqa: E402
from neuralrecon_w_tpu_torch.ops import voxel_grid  # noqa: E402
from neuralrecon_w_tpu_torch.training import surface  # noqa: E402
from test_torch_field_forward import make_pair, small_cfg  # noqa: E402

torch.set_num_threads(1)

# a cell whose SDF lies within AMBIGUOUS of the threshold may fall either
# side: the two sweeps sum in different orders (f32, ~1e-7 apart); at
# most AMBIGUOUS_FRAC of the candidates may be such cells
AMBIGUOUS, AMBIGUOUS_FRAC = 1e-5, 1e-3
SCENE = {"eval_bbx": [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], "sfm2gt": np.eye(4).tolist(),
         "origin": [0.0, 0.0, 0.0], "radius": 1.0}


def shell_points(n=400, seed=1):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v * rng.uniform(0.3, 0.7, (n, 1))


def cell_set(coords):
    return set(map(tuple, np.asarray(coords).tolist()))


@pytest.mark.parametrize("tvs", [0.3, 0.03, 0.0117, 0.5])
@pytest.mark.parametrize("sfm2gt", ["eye", "scaled"])
def test_surface_level_matches_jax(tvs, sfm2gt):
    sc = dict(SCENE)
    if sfm2gt == "scaled":
        m = np.eye(4) * 2.5
        m[3, 3], m[:3, 3] = 1.0, [0.3, -1.0, 2.0]
        sc["sfm2gt"] = m.tolist()
    assert surface.surface_level(sc, tvs) == jax_surface.surface_level(sc, tvs)


def test_voxel_grid_helpers_match_jax():
    """centers_sfm, upsample, level_for_voxel_size and scene_bbx_sfm's
    arguments."""
    pts = shell_points()
    args = (pts, [-1, -1, -1], [1, 1, 1], 0.1)
    for expand, radius in ((0, 1.0), (1, 1.0), (2, 1.5)):
        got = voxel_grid.grid_from_points(*args, expand=expand, radius=radius)
        want = jax_vg.grid_from_points(*args, expand=expand, radius=radius)
        assert got.level == want.level and got.scale == want.scale
        assert cell_set(got.coords) == cell_set(want.coords)
    g, w = voxel_grid.grid_from_points(*args, expand=1), jax_vg.grid_from_points(*args, expand=1)
    order = np.lexsort(np.asarray(w.coords).T[::-1])
    np.testing.assert_array_equal(g.centers_sfm(), w.centers_sfm()[order])
    assert cell_set(g.upsample(g.level + 1).coords) == cell_set(w.upsample(w.level + 1).coords)
    for scale, vs in ((1.0, 0.1), (1.5, 0.0117), (3.0, 0.2)):
        for mode in ("floor", "ceil"):
            assert (voxel_grid.level_for_voxel_size(scale, vs, mode)
                    == jax_vg.level_for_voxel_size(scale, vs, mode))
    sc = dict(SCENE, eval_bbx_detail=[[0.5, -0.2, 0.1], [-0.3, 0.4, 0.9]],
              sfm2gt=(np.eye(4) * 2.0 + np.eye(4)[3:].T @ np.eye(4)[3:] * -1.0).tolist())
    for name in ("eval_bbx", "eval_bbx_detail"):
        for in_sfm in (True, False):
            for a, b in zip(voxel_grid.scene_bbx_sfm(sc, name, in_sfm),
                            jax_vg.scene_bbx_sfm(sc, name, in_sfm)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_octree_update_matches_jax(threshold):
    """The same cells kept, but for cells within AMBIGUOUS of the
    threshold (counted and bounded); the same stats; a device grid on the
    model's device."""
    cfg = small_cfg()
    params, model, fc = make_pair(cfg)
    from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config

    jfc = jax_field_config(cfg)
    pts = shell_points()
    g = voxel_grid.grid_from_points(pts, [-1, -1, -1], [1, 1, 1], 0.1, expand=1)
    w = jax_vg.grid_from_points(pts, [-1, -1, -1], [1, 1, 1], 0.1, expand=1)
    stats, jstats = {}, {}
    host, dev = surface.octree_update(model, fc, g, SCENE, np.zeros(3), 1.0, 0.03, threshold,
                                      chunk=4096, stats_out=stats)
    jhost, _ = jax_surface.octree_update(params, jfc, w, SCENE, np.zeros(3), 1.0, 0.03,
                                         threshold, chunk=4096, stats_out=jstats)
    assert host.level == jhost.level == 7
    assert np.array_equal(host.origin, jhost.origin) and host.scale == jhost.scale
    assert dev.occ.device.type == "cpu"
    # the JAX sweep's SDF at every candidate marks the ambiguous cells
    dense = w.upsample(7)
    sdf = jax_sweep.sharded_sdf_sweep(params, jfc, dense.centers_sfm().astype(np.float32),
                                      chunk=4096)
    ambiguous = cell_set(dense.coords[np.abs(sdf - threshold) < AMBIGUOUS])
    got, want = cell_set(host.coords), cell_set(jhost.coords)
    assert (got ^ want) <= ambiguous
    assert len(ambiguous) <= AMBIGUOUS_FRAC * stats["n_candidates"]
    assert stats["n_candidates"] == jstats["n_candidates"] == len(dense.coords)
    assert abs(stats["n_kept"] - jstats["n_kept"]) <= len(ambiguous)
    assert 0 < stats["n_kept"] < stats["n_candidates"]


def test_octree_update_degenerate_sdf_warns(caplog):
    """A refresh that keeps more than 90 % of the candidates warns, as
    tests/test_training.py's does for the JAX package; a healthy one does
    not."""
    cfg = small_cfg()
    _, model, fc = make_pair(cfg)
    g = voxel_grid.grid_from_points(shell_points(), [-1, -1, -1], [1, 1, 1], 0.5, expand=0)
    name = "neuralrecon_w_tpu_torch.training.surface"
    for threshold, expect in ((1e6, True), (0.0, False)):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=name):
            surface.octree_update(model, fc, g, SCENE, np.zeros(3), 1.0, 0.3, threshold,
                                  chunk=256)
        assert any("degenerate" in r.message for r in caplog.records) == expect


def test_octree_update_keeps_nothing():
    """No cell under the threshold: (None, None), the caller keeps its grid."""
    cfg = small_cfg()
    _, model, fc = make_pair(cfg)
    g = voxel_grid.grid_from_points(shell_points(), [-1, -1, -1], [1, 1, 1], 0.5, expand=0)
    assert surface.octree_update(model, fc, g, SCENE, np.zeros(3), 1.0, 0.3, -1e6,
                                 chunk=256) == (None, None)
