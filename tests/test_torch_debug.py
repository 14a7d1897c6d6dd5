"""PyTorch port, the render debug trace: trace_render against the JAX
package's on the same weights and rays, the three PLY dumps read back, and
the port's 'jet' colours against matplotlib's."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config  # noqa: E402
from neuralrecon_w_tpu.ops.ray_voxel import device_grid_from_host as jax_device_grid  # noqa: E402
from neuralrecon_w_tpu.rendering import debug as jax_debug  # noqa: E402
from neuralrecon_w_tpu.rendering import render_config_from_cfg as jax_render_config  # noqa: E402
from neuralrecon_w_tpu.rendering.renderer import SceneInfo as JaxSceneInfo  # noqa: E402
from neuralrecon_w_tpu_torch.config import field_config_from_cfg, render_config_from_cfg  # noqa: E402
from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host  # noqa: E402
from neuralrecon_w_tpu_torch.rendering import debug  # noqa: E402
from neuralrecon_w_tpu_torch.rendering.renderer import SceneInfo  # noqa: E402
from neuralrecon_w_tpu_torch.utils.colormap import jet_uint8  # noqa: E402
from neuralrecon_w_tpu_torch.utils.ply import read_ply  # noqa: E402
from test_torch_render import make_rays, setup  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5


@pytest.mark.parametrize("phase", ["warmup", "steady"])
def test_trace_render_matches_jax(phase, tmp_path):
    """Weights, depth and surface points within 1e-5 of JAX's trace (perturb
    0 on both sides), the cdf within 1e-5 of sdf: it is sigmoid(sdf x
    inv_s), whose slope is at most inv_s / 4; and the dumps readable by
    read_ply."""
    cfg, params, model, host = setup()
    fine_level = host.level if phase == "steady" else -1
    jrc = jax_render_config(cfg, sfm_level=host.level, fine_level=fine_level)
    rc = render_config_from_cfg(cfg, sfm_level=host.level, fine_level=fine_level)
    rays, ts, labels = make_rays(seed=2)
    jgrid = jax_device_grid(host)
    want = jax_debug.trace_render(
        params, jax_field_config(cfg), jrc, JaxSceneInfo(jnp.zeros(3), jnp.asarray(2.0),
                                                          jnp.eye(4)),
        rays, ts, labels, jax.random.PRNGKey(0), fine_grid=jgrid if phase == "steady" else None,
        sfm_grid=jgrid)
    grid = device_grid_from_host(host, "cpu")
    got = debug.trace_render(
        model, field_config_from_cfg(cfg), rc,
        SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4)), rays, ts, labels,
        fine_grid=grid if phase == "steady" else None, sfm_grid=grid)
    assert got["n_fg_samples"] == want["n_fg_samples"]
    inv_s = 1.0 / float(got["render"]["s_val"])
    for k in ("weights", "cdf", "surface_points_sfm"):
        assert got[k].shape == want[k].shape, k
        tol = ATOL * max(1.0, inv_s / 4) if k == "cdf" else ATOL
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["render"]["depth"].numpy(), np.asarray(want["render"]["depth"]),
                               atol=ATOL, rtol=0)

    w = got["weights"].max(axis=1)
    debug.dump_weighted_points_ply(str(tmp_path / "w.ply"), got["surface_points_sfm"], w)
    debug.dump_grid_ply(str(tmp_path / "g.ply"), host)
    depth = got["render"]["depth"].numpy()
    debug.dump_depth_points_ply(str(tmp_path / "d.ply"), rays, depth)
    pw, pg, pd = (read_ply(str(tmp_path / f)) for f in ("w.ply", "g.ply", "d.ply"))
    np.testing.assert_allclose(pw["verts"], got["surface_points_sfm"], atol=1e-6)
    np.testing.assert_array_equal(pw["colors"], jet_uint8(np.clip(w / w.max(), 0, 1)))
    np.testing.assert_allclose(pg["verts"], host.centers_sfm(), atol=1e-6)
    assert len(pd["verts"]) == int((depth > 0).sum()) > 0


def test_jet_uint8_matches_matplotlib():
    """The port colours what JAX's dump colours with matplotlib's jet, within
    one level, without matplotlib."""
    matplotlib = pytest.importorskip("matplotlib")
    x = np.concatenate([np.linspace(0, 1, 1001), np.random.default_rng(0).random(500)])
    want = (matplotlib.colormaps["jet"](x)[:, :3] * 255).astype(np.uint8)
    assert int(np.abs(jet_uint8(x).astype(int) - want).max()) <= 1
