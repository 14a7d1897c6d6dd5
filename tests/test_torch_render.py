"""PyTorch port, the serving slice: render_rays in both serving phases and
render_image's chunk loop against the JAX package, and a check that the
port's serving path loads no JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralrecon_w_tpu.config import get_cfg_defaults  # noqa: E402
from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config  # noqa: E402
from neuralrecon_w_tpu.models import init_field as jax_init_field  # noqa: E402
from neuralrecon_w_tpu.ops.ray_voxel import device_grid_from_host as jax_device_grid  # noqa: E402
from neuralrecon_w_tpu.ops.voxel_grid import VoxelGrid  # noqa: E402
from neuralrecon_w_tpu.rendering import render_config_from_cfg as jax_render_config  # noqa: E402
from neuralrecon_w_tpu.rendering.renderer import SceneInfo as JaxSceneInfo  # noqa: E402
from neuralrecon_w_tpu.rendering.renderer import render_rays as jax_render_rays  # noqa: E402
from neuralrecon_w_tpu_torch.config import (  # noqa: E402
    field_config_from_cfg,
    render_config_from_cfg,
)
from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host  # noqa: E402
from neuralrecon_w_tpu_torch.rendering.renderer import SceneInfo, render_rays  # noqa: E402
from neuralrecon_w_tpu_torch.tools.convert import field_from_jax  # noqa: E402
from test_torch_sdf_mlp import live_field_params  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-4  # f32 end to end; the sampler's own bound
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("color", "depth", "weights", "gradients", "weights_sum")


def setup():
    """The brandenburg_gate_tpu operating point (8 + 16 samples in 2
    rounds at s_val_base 3, 6 boundary samples, 4 outside, bg_samples 8,
    near/far override) at a narrow width, in f32."""
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "config", "train_brandenburg_gate_tpu.yaml"))
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden = 64
    n.SDF_CONFIG.d_out = 65
    n.SDF_CONFIG.n_layers = 4
    n.SDF_CONFIG.skip_in = (2,)
    n.COLOR_CONFIG.d_feature = 64
    n.COLOR_CONFIG.d_hidden = 64
    n.COLOR_CONFIG.n_layers = 2
    n.N_VOCAB = 16
    cfg.TPU.FIELD_DTYPE = "float32"
    cfg.TPU.FUSED_SAMPLER_SDF = False  # JAX side: the jnp sampler on the CPU
    params = live_field_params(jax_init_field(jax.random.PRNGKey(0), jax_field_config(cfg)))
    model = field_from_jax(jax.tree.map(np.asarray, params), field_config_from_cfg(cfg), "cpu")
    # a slab of occupied cells across the cube centre: the SFM grid and,
    # for the steady phase, the fine grid
    cc = np.stack(np.meshgrid(np.arange(5, 11), np.arange(5, 11), [8, 9], indexing="ij"),
                  -1).reshape(-1, 3)
    host = VoxelGrid(4, np.zeros(3), 2.0, cc.astype(np.int32))
    return cfg, params, model.requires_grad_(False), host


def make_rays(r=24, seed=0):
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.0, -3.0]]), (r, 1))
    d = rng.standard_normal((r, 3)) * 0.3 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((r, 1), 1.0), np.full((r, 1), 5.0),
                           np.full((r, 1), 3.0), (rng.random((r, 1)) > 0.5)], -1)
    ts = rng.integers(0, 16, r).astype(np.int32)
    labels = np.zeros(r, np.int32)
    labels[:3] = 2  # sky rays (mesh mask)
    return rays.astype(np.float32), ts, labels


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("phase", ["warmup", "steady"])
def test_render_rays_matches_jax(phase, fused):
    """Warm-up: SFM-override near/far, no fine grid. Steady: plus the fine
    grid's surface band and boundary samples. fused: the port's
    kernel-path sampler (its plain versions on the CPU) or its jnp-style
    path; JAX runs its jnp sampler."""
    cfg, params, model, host = setup()
    fine_level = host.level if phase == "steady" else -1
    jrc = jax_render_config(cfg, sfm_level=host.level, fine_level=fine_level, perturb=0.0)
    rc = render_config_from_cfg(cfg, sfm_level=host.level, fine_level=fine_level,
                                perturb=0.0)._replace(fused_sampler_sdf=fused)
    assert (rc.n_samples, rc.n_importance, rc.up_sample_steps, rc.s_val_base,
            rc.boundary_samples, rc.n_outside, rc.bg_samples) == (8, 16, 2, 3, 6, 4, 8)
    rays, ts, labels = make_rays()
    jgrid = jax_device_grid(host)
    jfc = jax_field_config(cfg)
    want = jax.jit(lambda p, r, t, lab, fg, sg: jax_render_rays(
        p, jfc, jrc, JaxSceneInfo(jnp.zeros(3), jnp.asarray(2.0), jnp.eye(4)), r, t, lab,
        jax.random.PRNGKey(0), 1.0, fine_grid=fg, sfm_grid=sg))(
        params, jnp.asarray(rays), jnp.asarray(ts), jnp.asarray(labels),
        jgrid if phase == "steady" else None, jgrid)
    grid = device_grid_from_host(host, "cpu")
    with torch.no_grad():
        got = render_rays(
            model, field_config_from_cfg(cfg), rc,
            SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4)),
            torch.from_numpy(rays), torch.from_numpy(ts), torch.from_numpy(labels), None, 1.0,
            fine_grid=grid if phase == "steady" else None, sfm_grid=grid)
    n_fg = 24 + (6 if phase == "steady" else 0)
    assert got["weights"].shape == (24, n_fg + 4)
    for k in KEYS + ("mask_error", "sfm_depth_sq", "color_bg", "gradient_error"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("phase", ["warmup", "steady"])
def test_render_rays_fused_field_and_background_match_jax(phase):
    """One served chunk with SDF_GRAD_MODE 'pallas_field' and FUSED_BG on
    (the fused field and background kernels' plain versions on the CPU)
    against the JAX render in its default modes, f32."""
    cfg, params, model, host = setup()
    fine_level = host.level if phase == "steady" else -1
    jrc = jax_render_config(cfg, sfm_level=host.level, fine_level=fine_level, perturb=0.0)
    rc = render_config_from_cfg(cfg, sfm_level=host.level, fine_level=fine_level, perturb=0.0)
    rays, ts, labels = make_rays(seed=4)
    jgrid = jax_device_grid(host)
    jfc = jax_field_config(cfg)
    want = jax.jit(lambda p, r, t, lab, fg, sg: jax_render_rays(
        p, jfc, jrc, JaxSceneInfo(jnp.zeros(3), jnp.asarray(2.0), jnp.eye(4)), r, t, lab,
        jax.random.PRNGKey(0), 1.0, fine_grid=fg, sfm_grid=sg))(
        params, jnp.asarray(rays), jnp.asarray(ts), jnp.asarray(labels),
        jgrid if phase == "steady" else None, jgrid)
    cfg.TPU.SDF_GRAD_MODE, cfg.TPU.FUSED_BG = "pallas_field", True
    fc = field_config_from_cfg(cfg)
    assert (fc.grad_mode, fc.bg_mode) == ("pallas_field", "pallas")
    grid = device_grid_from_host(host, "cpu")
    with torch.no_grad():
        got = render_rays(
            model, fc, rc, SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4)),
            torch.from_numpy(rays), torch.from_numpy(ts), torch.from_numpy(labels), None, 1.0,
            fine_grid=grid if phase == "steady" else None, sfm_grid=grid)
    for k in KEYS + ("color_bg", "gradient_error"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0,
                                   err_msg=k)


def test_render_rays_floor_loss_matches_jax():
    """FLOOR_NORMAL on (off at the operating point): the floor-normal and
    floor-height terms over road-labelled rays, under a rotated sfm2gt."""
    cfg, params, model, host = setup()
    cfg.NEUCONW.FLOOR_NORMAL = True
    jrc = jax_render_config(cfg, sfm_level=host.level, perturb=0.0)
    rc = render_config_from_cfg(cfg, sfm_level=host.level, perturb=0.0)
    assert rc.floor_normal and rc.floor_label_ids == (6,)
    rays, ts, labels = make_rays(seed=2)
    labels[5:15] = 6  # road
    c, s_ = np.cos(0.3), np.sin(0.3)
    sfm2gt = np.array([[1, 0, 0, 0], [0, c, -s_, 0], [0, s_, c, 0], [0, 0, 0, 1]], np.float32)
    jfc = jax_field_config(cfg)
    want = jax.jit(lambda p, r, t, lab, sg: jax_render_rays(
        p, jfc, jrc, JaxSceneInfo(jnp.zeros(3), jnp.asarray(2.0), jnp.asarray(sfm2gt)), r, t,
        lab, jax.random.PRNGKey(0), 1.0, sfm_grid=sg))(
        params, jnp.asarray(rays), jnp.asarray(ts), jnp.asarray(labels), jax_device_grid(host))
    with torch.no_grad():
        got = render_rays(
            model, field_config_from_cfg(cfg), rc,
            SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.from_numpy(sfm2gt)),
            torch.from_numpy(rays), torch.from_numpy(ts), torch.from_numpy(labels), None, 1.0,
            sfm_grid=device_grid_from_host(host, "cpu"))
    assert float(got["floor_count"]) == 10.0
    for k in ("floor_normal_error", "floor_y_error", "floor_count"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0,
                                   err_msg=k)


def test_render_rays_perturbed_draws_from_its_generator():
    """perturb 1 (training's jitter): the draws come from the generator
    passed in, so a seed reproduces a render and another seed moves it."""
    cfg, _, model, host = setup()
    rc = render_config_from_cfg(cfg, sfm_level=host.level, perturb=1.0)
    rays, ts, labels = make_rays(seed=3)
    grid = device_grid_from_host(host, "cpu")

    def render(seed):
        with torch.no_grad():
            return render_rays(
                model, field_config_from_cfg(cfg), rc,
                SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4)),
                torch.from_numpy(rays), torch.from_numpy(ts), torch.from_numpy(labels),
                torch.Generator().manual_seed(seed), 1.0, sfm_grid=grid)

    a, b, c = render(0), render(0), render(1)
    assert all(torch.isfinite(a[k]).all() for k in KEYS)
    assert torch.equal(a["color"], b["color"]) and torch.equal(a["depth"], b["depth"])
    assert not torch.equal(a["depth"], c["depth"])


def test_render_image_matches_jax():
    """The chunk loop with a ragged last chunk, steady phase."""
    from neuralrecon_w_tpu.training.step import make_render_fn as jax_make_render_fn
    from neuralrecon_w_tpu.training.validation import render_image as jax_render_image
    from neuralrecon_w_tpu_torch.training.step import make_render_fn
    from neuralrecon_w_tpu_torch.training.validation import render_image

    cfg, params, model, host = setup()
    rays, ts, labels = make_rays(r=20, seed=1)
    jrc = jax_render_config(cfg, sfm_level=host.level, fine_level=host.level)
    rc = render_config_from_cfg(cfg, sfm_level=host.level,
                                fine_level=host.level)._replace(fused_sampler_sdf=True)
    jgrid = jax_device_grid(host)
    want = jax_render_image(jax_make_render_fn(jax_field_config(cfg), jrc), params,
                            JaxSceneInfo(jnp.zeros(3), jnp.asarray(2.0), jnp.eye(4)),
                            rays, ts, labels, (5, 4), chunk=8, fine_grid=jgrid, sfm_grid=jgrid)
    grid = device_grid_from_host(host, "cpu")
    got = render_image(make_render_fn(field_config_from_cfg(cfg), rc), model,
                       SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4)),
                       rays, ts, labels, (5, 4), chunk=8, fine_grid=grid, sfm_grid=grid)
    for k in ("color", "depth", "normal"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0, err_msg=k)


def test_serving_path_loads_no_jax():
    """A fresh interpreter renders one tiny chunk through the port's
    serving entry points with JAX, and the JAX package, never imported."""
    code = """
import sys
import numpy as np
import torch
from neuralrecon_w_tpu_torch.ops.voxel_grid import VoxelGrid
from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg, render_config_from_cfg
from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
from neuralrecon_w_tpu_torch.models.neuconw import init_field
from neuralrecon_w_tpu_torch.training.step import make_render_fn
from neuralrecon_w_tpu_torch.training.validation import render_image
from neuralrecon_w_tpu_torch.utils.scene import scene_info

torch.set_num_threads(1)
cfg = load_cfg("config/train_brandenburg_gate_tpu.yaml")
n = cfg.NEUCONW
n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
n.SDF_CONFIG.skip_in = (2,)
n.COLOR_CONFIG.d_feature, n.N_VOCAB = 64, 4
fc = field_config_from_cfg(cfg)
model = init_field(fc, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
cc = np.stack(np.meshgrid(range(5, 11), range(5, 11), [8], indexing="ij"), -1).reshape(-1, 3)
grid = device_grid_from_host(VoxelGrid(4, np.zeros(3), 2.0, cc.astype(np.int32)), "cpu")
rc = render_config_from_cfg(cfg, sfm_level=4, fine_level=4)
rays = np.tile(np.array([[0, 0, -3, 0, 0, 1, 1, 5, 0, 0]], np.float32), (6, 1))
out = render_image(make_render_fn(fc, rc), model, scene_info({"origin": [0, 0, 0], "radius": 2.0}, "cpu"),
                   rays, np.zeros(6, np.int32), np.zeros(6, np.int32), (3, 2), chunk=4,
                   fine_grid=grid, sfm_grid=grid)
assert np.isfinite(out["color"]).all() and out["color"].shape == (2, 3, 3)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")
