"""PyTorch port, the device pool's training step on the CPU: a step that
reads the pool's surface-band cache against the step that queries the
grid and against the JAX step with the same cache; ``make_scan_train_fn``'s
loop against the JAX package's scan over the same permutation window; the
LR schedules evaluated from a device count (tests/test_training.py:579)."""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralrecon_w_tpu.datasets.cache import DeviceRayPool as JaxDeviceRayPool  # noqa: E402
from neuralrecon_w_tpu.datasets.cache import RayPool as JaxRayPool  # noqa: E402
from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config  # noqa: E402
from neuralrecon_w_tpu.models import init_field as jax_init_field  # noqa: E402
from neuralrecon_w_tpu.ops.ray_voxel import device_grid_from_host as jax_device_grid  # noqa: E402
from neuralrecon_w_tpu.ops.ray_voxel import grid_near_far as jax_grid_near_far  # noqa: E402
from neuralrecon_w_tpu.rendering import render_config_from_cfg as jax_render_config  # noqa: E402
from neuralrecon_w_tpu.rendering.renderer import SceneInfo as JaxSceneInfo  # noqa: E402
from neuralrecon_w_tpu.training import loss_config_from_cfg as jax_loss_config  # noqa: E402
from neuralrecon_w_tpu.training.schedule import make_optimizer as jax_make_optimizer  # noqa: E402
from neuralrecon_w_tpu.training.step import init_state as jax_init_state  # noqa: E402
from neuralrecon_w_tpu.training.step import make_scan_train_fn as jax_scan_fn  # noqa: E402
from neuralrecon_w_tpu_torch import config  # noqa: E402
from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool, RayPool  # noqa: E402
from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host, grid_near_far  # noqa: E402
from neuralrecon_w_tpu_torch.rendering.renderer import SceneInfo  # noqa: E402
from neuralrecon_w_tpu_torch.tools.convert import (  # noqa: E402
    field_from_jax,
    params_from_jax,
    state_from_jax,
)
from neuralrecon_w_tpu_torch.training.losses import loss_config_from_cfg  # noqa: E402
from neuralrecon_w_tpu_torch.training.schedule import make_lr_schedule, make_optimizer  # noqa: E402
from neuralrecon_w_tpu_torch.training.step import (  # noqa: E402
    ScanRun,
    TrainState,
    make_scan_train_fn,
    make_train_step,
)
from test_torch_sdf_mlp import live_field_params  # noqa: E402
from test_torch_train_step import (  # noqa: E402
    Capture,
    grid_host,
    jax_step,
    make_batch,
    ray_mask_ids,
    rel_l2,
    setup_cfg,
)

torch.set_num_threads(1)

# one step with the band cache, f32, PERTURB 0: against the in-step query
# (the same DDA on the same ray, its origin only re-rounded on the way
# through the unit sphere) and against JAX's step with the same cache (the
# frameworks' op order moves the scalars by up to ~4e-7)
CACHE_RTOL = 1e-6
# the port against JAX, one step or three: op order (test_torch_train_step's)
LOSS_RTOL = 1e-4
SCALAR_ATOL = 1e-4
GRAD_REL_L2 = 5e-3
# Adam moves a parameter by about lr a step whatever its gradient's size, so
# a gradient within rounding of 0 can take either sign: after n steps a
# parameter may differ by up to 2 n lr; all but PARAM_FRAC of them agree
# within PARAM_ATOL (test_torch_trainer.py's rule)
PARAM_ATOL, PARAM_FRAC = 1e-5, 1e-3
BATCH, N_INNER, POOL_ROWS = 64, 3, 256
# SGD and RAdam move a parameter by about lr |g|, far below PARAM_ATOL, so
# their windows are held by the change of the parameters over the window:
# the port's change within CHANGE_REL_L2 (rel-L2) of JAX's. Their window is
# OPT_INNER steps, so that RAdam's crosses from its unrectified updates 1-5
# into the rectified 6 and 7
CHANGE_REL_L2 = 5e-3
OPT_INNER = 7


def port_step_aux(cfg, params, batch, fine, surface_query, cached):
    """One port step ('vjp', f32, PERTURB 0) from JAX's parameters: its aux
    and gradients, with the band from the batch's cache or the grid."""
    pcfg = copy.deepcopy(cfg)
    pcfg.TPU.SURFACE_QUERY = surface_query
    fc = config.field_config_from_cfg(pcfg)
    rc = config.render_config_from_cfg(pcfg, sfm_level=-1, fine_level=fine.level,
                                       nerf_far_override=False)
    model = field_from_jax(jax.tree.map(np.asarray, params), fc, "cpu")
    state = TrainState(model, Capture(model), 3)
    step = make_train_step(fc, rc, loss_config_from_cfg(pcfg), int(cfg.NEUCONW.ANNEAL_END),
                           ray_mask_ids(cfg))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    grid = device_grid_from_host(fine, "cpu")
    if cached:
        surf, _, hit = grid_near_far(grid, fine.level, b["rays"][:, 0:3], b["rays"][:, 3:6],
                                     first_only=True)
        assert bool(hit.any()) and bool((~hit).any())
        b.update(surf_t=surf, surf_hit=hit)
    scene = SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4))
    _, aux = step(state, scene, b, grid, None)
    return {k: float(v) for k, v in aux.items()}, state.optimizer.grads


def test_band_cache_step_matches_query_and_jax():
    """A step with surf_t / surf_hit in the batch equals the step with
    SURFACE_QUERY 'dda' and JAX's step with the same cache (CACHE_RTOL;
    JAX's gradients within GRAD_REL_L2), at PERTURB 0 in f32."""
    cfg = setup_cfg()
    params = live_field_params(jax_init_field(jax.random.PRNGKey(0), jax_field_config(cfg)))
    batch = make_batch()
    fine = grid_host()
    q_aux, q_g = port_step_aux(cfg, params, batch, fine, "dda", cached=False)
    c_aux, c_g = port_step_aux(cfg, params, batch, fine, "sampled", cached=True)
    for k, v in q_aux.items():
        assert c_aux[k] == pytest.approx(v, rel=CACHE_RTOL, abs=1e-12), k
    for k in q_g:
        assert rel_l2(c_g[k].numpy(), q_g[k].numpy()) <= CACHE_RTOL, k

    surf, _, hit = jax_grid_near_far(jax_device_grid(fine), fine.level,
                                     jnp.asarray(batch["rays"][:, 0:3]),
                                     jnp.asarray(batch["rays"][:, 3:6]), first_only=True)
    want_aux, want_g = jax_step(cfg, params, dict(batch, surf_t=np.asarray(surf),
                                                  surf_hit=np.asarray(hit)), fine)
    for k, v in want_aux.items():
        assert c_aux[k] == pytest.approx(v, rel=CACHE_RTOL, abs=1e-12), k
    bad = {k: e for k in want_g if (e := rel_l2(c_g[k].numpy(), want_g[k].numpy())) > GRAD_REL_L2}
    assert not bad, bad


def pool_rows(n=POOL_ROWS, seed=0):
    """make_batch's rays as 12-column cache rows (labels in column 9)."""
    b = make_batch(n, seed)
    rays = np.concatenate([b["rays"][:, :8], b["ts"][:, None].astype(np.float32),
                           b["labels"][:, None].astype(np.float32), b["rays"][:, 8:10]], axis=1)
    return rays, b["rgbs"]


# the port's grad modes ('pallas_field' with FUSED_BG) and the JAX mode each
# is held to: JAX's kernel modes run Pallas, which its scan cannot
# interpret on the CPU, so they are held to JAX's 'vjp' window, as
# test_torch_train_step holds one step of them; 'fwd' to JAX's 'fwd'
SCAN_MODES = {"vjp": "vjp", "pallas": "vjp", "pallas_hybrid": "vjp", "pallas_field": "vjp",
              "fwd": "fwd"}
_JAX_WINDOWS: dict = {}


def jax_scan_window(cfg, phase, jax_mode, rays, rgbs, perm, start, n_inner=N_INNER):
    """JAX's make_scan_train_fn over the window of ``n_inner`` steps in
    ``jax_mode`` from the live initial state: (numpy initial state, final
    state, last aux), computed once per phase, mode and TRAINER.OPTIMIZER."""
    key = (phase, jax_mode, cfg.TRAINER.OPTIMIZER)
    if key in _JAX_WINDOWS:
        return _JAX_WINDOWS[key]
    cfg = copy.deepcopy(cfg)
    cfg.TPU.SDF_GRAD_MODE = jax_mode
    fine = grid_host() if phase == "steady" else None
    level = fine.level if fine else -1
    jfc = jax_field_config(cfg)
    opt, _ = jax_make_optimizer(cfg, BATCH)
    jstate = jax_init_state(jax.random.PRNGKey(0), jfc, opt)
    jstate = jstate._replace(params=live_field_params(jstate.params))
    np_state = jax.device_get(jstate)
    jpool = JaxDeviceRayPool(JaxRayPool(rays, rgbs), None)
    jgrid = jax_device_grid(fine) if fine else None
    if fine:
        jpool.attach_surface(jgrid, level)
    jrun = jax_scan_fn(jfc, jax_render_config(cfg, sfm_level=-1, fine_level=level,
                                              nerf_far_override=False),
                       jax_loss_config(cfg), opt, int(cfg.NEUCONW.ANNEAL_END), ray_mask_ids(cfg),
                       BATCH, n_inner)
    jscene = JaxSceneInfo(jnp.zeros(3), jnp.asarray(2.0), jnp.eye(4))
    jout, jaux = jrun(jstate, jscene, jpool.data, jax.random.PRNGKey(2), jax.random.PRNGKey(3),
                      jgrid, None, jnp.asarray(perm, jnp.int32), jnp.asarray(start, jnp.int32))
    _JAX_WINDOWS[key] = (np_state, jax.device_get(jout),
                         {k: float(v) for k, v in jaux.items()})
    return _JAX_WINDOWS[key]


@pytest.mark.parametrize("mode,phase,opt", [
    pytest.param(m, p, "adam", id=p if m == "vjp" else f"{m}-{p}")
    for m in SCAN_MODES for p in ("warmup", "steady")] + [
    pytest.param("vjp", p, o, id=f"{o}-{p}") for o in ("sgd", "radam")
    for p in ("warmup", "steady")])
def test_scan_train_fn_matches_jax(phase, mode, opt):
    """make_scan_train_fn's loop (the CPU path, each kernel's plain version)
    over one window of a numpy permutation, from the JAX state carried
    across (state_from_jax), against the JAX package's scan over the same
    window: N_INNER steps with Adam in each grad mode (JAX's in
    SCAN_MODES[mode]), OPT_INNER steps in 'vjp' with each other
    TRAINER.OPTIMIZER. The last step's aux within LOSS_RTOL; the parameters
    by Adam's rule above, or for SGD and RAdam their change over the window
    within CHANGE_REL_L2 of JAX's; the steady phase reads each pool's band
    cache."""
    cfg = setup_cfg()
    cfg.TRAINER.OPTIMIZER = opt
    n_inner = N_INNER if opt == "adam" else OPT_INNER
    start = 64
    rows = start + n_inner * BATCH
    rays, rgbs = pool_rows(rows)
    perm = np.random.RandomState(1).permutation(rows)
    fine = grid_host() if phase == "steady" else None
    level = fine.level if fine else -1
    np_state, jout, jaux = jax_scan_window(cfg, phase, SCAN_MODES[mode], rays, rgbs, perm, start,
                                           n_inner)

    pcfg = copy.deepcopy(cfg)
    pcfg.TPU.SDF_GRAD_MODE = mode
    pcfg.TPU.FUSED_BG = mode == "pallas_field"  # the fused kernels' mode, as trained
    fc = config.field_config_from_cfg(pcfg)
    assert (fc.grad_mode, fc.bg_mode) == (mode, "pallas" if mode == "pallas_field" else "xla")
    spec, _ = make_optimizer(cfg, BATCH)
    state, _ = state_from_jax(np_state, fc, spec, device="cpu")
    p0 = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    pool = DeviceRayPool(RayPool(rays, rgbs), "cpu")
    grid = device_grid_from_host(fine, "cpu") if fine else None
    if fine:
        pool.attach_surface(grid, level)
    run = make_scan_train_fn(fc, config.render_config_from_cfg(cfg, sfm_level=-1,
                                                               fine_level=level,
                                                               nerf_far_override=False),
                             loss_config_from_cfg(cfg), int(cfg.NEUCONW.ANNEAL_END),
                             ray_mask_ids(cfg), BATCH, n_inner)
    assert isinstance(run, ScanRun)
    scene = SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4))
    state, aux = run(state, scene, pool.data, grid, None, torch.from_numpy(perm), start)
    assert state.step == int(jout.step) == n_inner and state.optimizer.count == n_inner
    assert run.captures == run.replays == 0  # the CPU path is the plain loop
    for k, v in jaux.items():
        tol = SCALAR_ATOL if k in ("psnr", "s_val") else LOSS_RTOL * abs(v)
        assert abs(float(aux[k]) - v) <= tol, (k, float(aux[k]), v)
    want = params_from_jax(jout.params)
    got = {k: v.detach() for k, v in state.model.state_dict().items()}
    if opt == "adam":
        diffs = np.concatenate([(got[k] - want[k]).abs().flatten().numpy() for k in want])
        lr = float(spec.schedule)
        assert diffs.max() <= 2 * n_inner * lr, diffs.max()
        assert (diffs > PARAM_ATOL).mean() <= PARAM_FRAC, (diffs > PARAM_ATOL).mean()
    else:
        d_got = torch.cat([(got[k] - p0[k]).flatten() for k in want]).numpy()
        d_want = torch.cat([(want[k] - p0[k]).flatten() for k in want]).numpy()
        assert np.linalg.norm(d_want) > 0
        assert rel_l2(d_got, d_want) <= CHANGE_REL_L2, rel_l2(d_got, d_want)


@pytest.mark.parametrize("sched", ["cosine", "steplr", "poly"])
def test_schedules_evaluate_from_a_device_count(sched):
    """The LR a captured step computes from its device update count equals
    the host schedule's (both float64)."""
    cfg = setup_cfg()
    cfg.TRAINER.LR_SCHEDULER = sched
    cfg.TRAINER.DECAY_STEP = [3, 7]
    schedule = make_lr_schedule(cfg, 2e-4, 10)
    assert callable(schedule)
    for count in range(0, 14):
        got = schedule(torch.tensor(float(count), dtype=torch.float64))
        assert float(got) == pytest.approx(schedule(count), rel=1e-12, abs=0), count
