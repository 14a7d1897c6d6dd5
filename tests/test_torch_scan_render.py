"""PyTorch port, the served frame as one call: ``make_scan_render_fn``
against the JAX package's (a ``lax.scan`` over chunk tiles) on weights
carried across by ``tools/convert.py``, against the port's own chunk loop,
and ``render_cli --dispatch scan`` against ``--dispatch chunk``. On the
CPU the scan render runs the plain loop of its chunk body; the captured
graph is held to the eager chunks on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import os

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config  # noqa: E402
from neuralrecon_w_tpu.ops.ray_voxel import device_grid_from_host as jax_device_grid  # noqa: E402
from neuralrecon_w_tpu.rendering import render_config_from_cfg as jax_render_config  # noqa: E402
from neuralrecon_w_tpu.rendering.renderer import SceneInfo as JaxSceneInfo  # noqa: E402
from neuralrecon_w_tpu_torch.config import (  # noqa: E402
    field_config_from_cfg,
    render_config_from_cfg,
)
from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host  # noqa: E402
from neuralrecon_w_tpu_torch.rendering.renderer import SceneInfo  # noqa: E402
from neuralrecon_w_tpu_torch.training.step import make_render_fn, make_scan_render_fn  # noqa: E402
from neuralrecon_w_tpu_torch.training.validation import render_image  # noqa: E402
from test_torch_render import ATOL, make_rays, setup  # noqa: E402

torch.set_num_threads(1)

CHUNK = 8
WH = (5, 4)  # 20 rays: 3 chunks of 8, the last padded from 4


def configs(phase):
    cfg, params, model, host = setup()
    fine_level = host.level if phase == "steady" else -1
    jrc = jax_render_config(cfg, sfm_level=host.level, fine_level=fine_level)
    rc = render_config_from_cfg(cfg, sfm_level=host.level, fine_level=fine_level)
    return cfg, params, model, host, jrc, rc._replace(fused_sampler_sdf=True)


# the port's grad modes ('pallas_field' with FUSED_BG) and the JAX mode each
# is held to: JAX's kernel modes run Pallas, which its scan render cannot
# interpret on the CPU, so they are held to JAX's 'vjp' frame, as
# test_torch_render holds one chunk of 'pallas_field'; 'fwd' to JAX's 'fwd'
SCAN_MODES = {"vjp": "vjp", "pallas": "vjp", "pallas_hybrid": "vjp", "pallas_field": "vjp",
              "fwd": "fwd"}


def mode_cfg(cfg, mode):
    """cfg in SDF_GRAD_MODE ``mode``, FUSED_BG with 'pallas_field'."""
    cfg = cfg.clone()
    cfg.TPU.SDF_GRAD_MODE = mode
    cfg.TPU.FUSED_BG = mode == "pallas_field"
    return cfg


@pytest.mark.parametrize("mode,phase", [
    pytest.param(m, p, id=p if m == "vjp" else f"{m}-{p}")
    for m in SCAN_MODES for p in ("warmup", "steady")])
def test_scan_render_matches_jax_and_the_chunk_loop(phase, mode):
    """color, depth and normal of a 20-ray frame (3 chunks, a ragged tail)
    through JAX's make_scan_render_fn (via its render_image) in
    SCAN_MODES[mode] and the port's in each grad mode (the kernels' plain
    versions on the CPU), within the serving tolerance (f32); and the
    port's equal to its own chunk loop, exactly (the same chunk body on the
    same inputs)."""
    from neuralrecon_w_tpu.training.step import make_render_fn as jax_make_render_fn
    from neuralrecon_w_tpu.training.step import make_scan_render_fn as jax_make_scan
    from neuralrecon_w_tpu.training.validation import render_image as jax_render_image

    cfg, params, model, host, jrc, rc = configs(phase)
    rays, ts, labels = make_rays(r=20, seed=5)
    jgrid = jax_device_grid(host)
    jfc = jax_field_config(mode_cfg(cfg, SCAN_MODES[mode]))
    cfg = mode_cfg(cfg, mode)
    fine = phase == "steady"
    want = jax_render_image(jax_make_render_fn(jfc, jrc), params,
                            JaxSceneInfo(jnp.zeros(3), jnp.asarray(2.0), jnp.eye(4)),
                            rays, ts, labels, WH, chunk=CHUNK,
                            fine_grid=jgrid if fine else None, sfm_grid=jgrid,
                            scan_render=jax_make_scan(jfc, jrc, CHUNK))
    grid = device_grid_from_host(host, "cpu")
    fc = field_config_from_cfg(cfg)
    assert (fc.grad_mode, fc.bg_mode) == (mode, "pallas" if mode == "pallas_field" else "xla")
    scene = SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4))
    run = make_scan_render_fn(fc, rc, CHUNK)
    got = render_image(make_render_fn(fc, rc), model, scene, rays, ts, labels, WH, chunk=CHUNK,
                       fine_grid=grid if fine else None, sfm_grid=grid, scan_render=run)
    loop = render_image(make_render_fn(fc, rc), model, scene, rays, ts, labels, WH, chunk=CHUNK,
                        fine_grid=grid if fine else None, sfm_grid=grid)
    for k, shape in (("color", (4, 5, 3)), ("depth", (4, 5)), ("normal", (4, 5, 3))):
        assert got[k].shape == want[k].shape == shape
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0, err_msg=k)
        np.testing.assert_array_equal(got[k], loop[k], err_msg=k)
    assert run.captures == 0 and run.replays == 0  # the plain loop on the CPU


def test_scan_render_run_on_padded_rays_matches_jax():
    """The run itself, on a frame already padded to 2 chunks: the three
    (N, ...) outputs of JAX's scan."""
    from neuralrecon_w_tpu.training.step import make_scan_render_fn as jax_make_scan

    cfg, params, model, host, jrc, rc = configs("steady")
    rays, ts, labels = make_rays(r=16, seed=6)
    jgrid = jax_device_grid(host)
    want = jax_make_scan(jax_field_config(cfg), jrc, CHUNK)(
        params, JaxSceneInfo(jnp.zeros(3), jnp.asarray(2.0), jnp.eye(4)), jnp.asarray(rays),
        jnp.asarray(ts), jnp.asarray(labels), jax.random.PRNGKey(0), jgrid, jgrid)
    grid = device_grid_from_host(host, "cpu")
    got = make_scan_render_fn(field_config_from_cfg(cfg), rc, CHUNK)(
        model, SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4)),
        torch.from_numpy(rays), torch.from_numpy(ts), torch.from_numpy(labels), None, grid, grid)
    assert sorted(got) == sorted(want) == ["color", "depth", "normal"]
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("mode", list(SCAN_MODES))
def test_scan_render_refuses_ragged_frames_and_serves_every_mode(mode):
    """A frame that is not whole chunks raises in every mode; a whole one
    renders in every mode (no mode is refused a scan render)."""
    cfg, _, model, host, _, rc = configs("warmup")
    cfg = mode_cfg(cfg, mode)
    rays, ts, labels = make_rays(r=12, seed=1)
    scene = SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4))
    args = (model, scene, torch.from_numpy(rays), torch.from_numpy(ts),
            torch.from_numpy(labels))
    fc = field_config_from_cfg(cfg)
    with pytest.raises(ValueError, match="chunks of 8"):
        make_scan_render_fn(fc, rc, CHUNK)(*args)
    run = make_scan_render_fn(fc, rc, 4)
    grid = device_grid_from_host(host, "cpu")
    out = run(*args, None, None, grid)
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        "color": (12, 3), "depth": (12,), "normal": (12, 3)}
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    assert run.captures == 0


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """The port's synthetic workspace, a small cfg (PERTURB 0) and a
    checkpoint of seeded weights with a fine grid."""
    from neuralrecon_w_tpu_torch.config import load_cfg
    from neuralrecon_w_tpu_torch.testing import make_synthetic_scene
    from neuralrecon_w_tpu_torch.models.neuconw import init_field
    from neuralrecon_w_tpu_torch.training.checkpoint import save_checkpoint
    from neuralrecon_w_tpu_torch.utils.scene import load_scene_bundle

    base = tmp_path_factory.mktemp("scan_cli")
    root = str(base / "sphere_scene")
    make_synthetic_scene(root, n_images=4, n_test=1, img_wh=(40, 30))
    cfg_dict = {
        "NEUCONW": {
            "N_SAMPLES": 8, "N_IMPORTANCE": 4, "UP_SAMPLE_STEP": 1, "N_OUTSIDE": 2,
            "BOUNDARY_SAMPLES": 2, "S_VAL_BASE": 1, "SAMPLE_RANGE": 4, "N_VOCAB": 16,
            "NEAR_FAR_OVERRIDE": True, "PERTURB": 0.0,
            "SDF_CONFIG": {"d_hidden": 32, "d_out": 33, "n_layers": 2, "skip_in": []},
            "COLOR_CONFIG": {"d_feature": 32, "d_hidden": 16, "n_layers": 2,
                             "head_channels": 8},
        },
        "DATASET": {"ROOT_DIR": root, "DATASET_NAME": "phototourism",
                    "PHOTOTOURISM": {"IMG_DOWNSCALE": 1}},
    }
    cfg_path = str(base / "train_sphere.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg_dict, f)
    cfg = load_cfg(cfg_path)
    model = init_field(field_config_from_cfg(cfg), torch.Generator().manual_seed(0), "cpu")
    sfm = load_scene_bundle(cfg, 1, "cpu").sfm_grid
    fine = sfm.upsample(sfm.level + 1)
    keep = np.abs(np.linalg.norm(fine.centers_sfm(), axis=-1) - 1.0) < 0.2
    fine = type(fine)(fine.level, fine.origin, fine.scale, fine.coords[keep])
    ck = save_checkpoint(str(base / "ck.ckpt"), model, 3, fine_grid=fine)
    return cfg_path, ck, str(base)


@pytest.mark.parametrize("case", [["--img_ids", "1,2"], ["--a_interp", "1,2", "--frames", "2"]])
def test_render_cli_scan_and_chunk_dispatch_write_the_same_images(cli_setup, case):
    from neuralrecon_w_tpu_torch.tools.render_cli import main

    cfg_path, ck, base = cli_setup
    tag = case[0].strip("-")
    common = ["--cfg_path", cfg_path, "--ckpt_path", ck, "--img_downscale", "2", "--chunk",
              "128", "--device", "cpu"] + case
    outs = {d: os.path.join(base, f"{tag}_{d}") for d in ("scan", "chunk")}
    for d, out in outs.items():
        main(common + ["--out_dir", out, "--dispatch", d])
    names = sorted(os.listdir(outs["scan"]))
    assert names == sorted(os.listdir(outs["chunk"])) and len(names) == 6
    for name in names:
        with open(os.path.join(outs["scan"], name), "rb") as a, \
                open(os.path.join(outs["chunk"], name), "rb") as b:
            assert a.read() == b.read(), name
