"""PyTorch port, the training slice: one step of make_train_step against the
JAX package's (every loss term, every parameter gradient, psnr, s_val) in
both training phases and grad modes, the create_graph repair, the losses,
the ray mask, the optimiser and schedules, and RayPool."""

import copy
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from neuralrecon_w_tpu.config import get_cfg_defaults  # noqa: E402
from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config  # noqa: E402
from neuralrecon_w_tpu.models import init_field as jax_init_field  # noqa: E402
from neuralrecon_w_tpu.ops.ray_voxel import device_grid_from_host as jax_device_grid  # noqa: E402
from neuralrecon_w_tpu.ops.voxel_grid import VoxelGrid  # noqa: E402
from neuralrecon_w_tpu.rendering import render_config_from_cfg as jax_render_config  # noqa: E402
from neuralrecon_w_tpu.rendering.renderer import SceneInfo as JaxSceneInfo  # noqa: E402
from neuralrecon_w_tpu.training import loss_config_from_cfg as jax_loss_config  # noqa: E402
from neuralrecon_w_tpu.training import make_train_step as jax_make_train_step  # noqa: E402
from neuralrecon_w_tpu.training.step import TrainState as JaxTrainState  # noqa: E402
from neuralrecon_w_tpu_torch import config  # noqa: E402
from neuralrecon_w_tpu_torch.datasets.mask_utils import get_label_id_mapping  # noqa: E402
from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host  # noqa: E402
from neuralrecon_w_tpu_torch.rendering.renderer import SceneInfo  # noqa: E402
from neuralrecon_w_tpu_torch.tools.convert import field_from_jax, params_from_jax  # noqa: E402
from neuralrecon_w_tpu_torch.training.losses import (  # noqa: E402
    batch_counts, loss_config_from_cfg, loss_terms)
from neuralrecon_w_tpu_torch.training.step import (  # noqa: E402
    TrainState,
    make_train_step,
    ray_mask_from_labels,
)
from test_torch_sdf_mlp import live_field_params  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 5e-3
SCALAR_ATOL = 1e-4
SKY, PERSON = 2, 12


def setup_cfg():
    """The brandenburg_gate_tpu operating point (8 + 16 samples in 2 rounds,
    6 boundary samples, 4 outside, bg_samples 8, the colour, eikonal,
    mesh-mask and SFM-depth terms, the ray mask) at SDF 4 x 64, colour
    2 x 32, 8 appearance codes, float32, perturb 0."""
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "config", "train_brandenburg_gate_tpu.yaml"))
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
    n.SDF_CONFIG.skip_in = (2,)
    n.COLOR_CONFIG.d_feature, n.COLOR_CONFIG.d_hidden, n.COLOR_CONFIG.n_layers = 64, 32, 2
    n.N_VOCAB = 8
    n.PERTURB = 0.0
    n.ANNEAL_END = 10
    cfg.TPU.FIELD_DTYPE = "float32"
    cfg.TPU.FUSED_SAMPLER_SDF = False  # JAX side: the jnp sampler on the CPU
    return cfg


def make_batch(r=64, seed=0):
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.0, -3.0]]), (r, 1)) + rng.standard_normal((r, 3)) * 0.05
    d = rng.standard_normal((r, 3)) * 0.3 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depth_w = (rng.random((r, 1)) > 0.5).astype(np.float64)
    rays = np.concatenate([o, d, np.full((r, 1), 1.0), np.full((r, 1), 5.0),
                           np.full((r, 1), 3.0), depth_w], -1).astype(np.float32)
    labels = np.zeros(r, np.int32)
    labels[:6] = SKY  # mesh mask
    labels[6:12] = PERSON  # ray mask
    return {"rays": rays, "ts": rng.integers(0, 8, r).astype(np.int32), "labels": labels,
            "rgbs": rng.random((r, 3)).astype(np.float32)}


def grid_host():
    cc = np.stack(np.meshgrid(np.arange(5, 11), np.arange(5, 11), [8, 9], indexing="ij"),
                  -1).reshape(-1, 3)
    return VoxelGrid(4, np.zeros(3), 2.0, cc.astype(np.int32))


def grads_capture():
    """An optax transformation whose state after one update is the gradient
    and whose update is zero: the JAX step's gradients, read from its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


class Capture:
    """Stands in for the port's optimiser: keeps the gradients of one step."""

    def __init__(self, model):
        self.model, self.grads = model, None

    def zero_grad(self):
        self.model.zero_grad(set_to_none=True)

    def step(self):
        self.grads = {k: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                      for k, p in self.model.named_parameters()}


def jax_step(cfg, params, batch, fine):
    fc = jax_field_config(cfg)
    rc = jax_render_config(cfg, sfm_level=-1, fine_level=fine.level if fine else -1,
                           nerf_far_override=False)
    step = jax_make_train_step(fc, rc, jax_loss_config(cfg), grads_capture(),
                               int(cfg.NEUCONW.ANNEAL_END), ray_mask_ids(cfg))
    state = JaxTrainState(params, grads_capture().init(params), jnp.asarray(3, jnp.int32))
    scene = JaxSceneInfo(jnp.zeros(3), jnp.asarray(2.0), jnp.eye(4))
    out, aux = jax.jit(step)(state, scene, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0), jax_device_grid(fine) if fine else None, None)
    grads = params_from_jax(jax.tree.map(np.asarray, out.opt_state))
    return {k: float(v) for k, v in aux.items()}, grads


def port_step(cfg, params, batch, fine, grad_mode):
    pcfg = copy.deepcopy(cfg)
    pcfg.TPU.SDF_GRAD_MODE = grad_mode
    pcfg.TPU.FUSED_BG = grad_mode == "pallas_field"  # the fused kernels' mode, as trained
    fc = config.field_config_from_cfg(pcfg)
    assert fc.bg_mode == ("pallas" if grad_mode == "pallas_field" else "xla")
    rc = config.render_config_from_cfg(pcfg, sfm_level=-1,
                                       fine_level=fine.level if fine else -1,
                                       nerf_far_override=False)
    assert rc.perturb == 0.0 and fc.grad_mode == grad_mode
    model = field_from_jax(jax.tree.map(np.asarray, params), fc, "cpu")
    state = TrainState(model, Capture(model), 3)
    step = make_train_step(fc, rc, loss_config_from_cfg(pcfg), int(cfg.NEUCONW.ANNEAL_END),
                           ray_mask_ids(cfg))
    scene = SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4))
    state, aux = step(state, scene, batch, device_grid_from_host(fine, "cpu") if fine else None)
    assert state.step == 4
    return {k: float(v) for k, v in aux.items()}, state.optimizer.grads


def ray_mask_ids(cfg):
    lid = get_label_id_mapping()
    return tuple(lid[x] for x in cfg.NEUCONW.RAY_MASK_LIST)


def rel_l2(got, want):
    den = float(np.linalg.norm(want))
    return float(np.linalg.norm(got - want)) / den if den > 0 else float(np.linalg.norm(got))


@pytest.mark.parametrize("grad_mode", ["vjp", "pallas", "pallas_field"])
@pytest.mark.parametrize("phase", ["warmup", "steady"])
def test_train_step_matches_jax(phase, grad_mode):
    """One step on live weights (seeded noise on the SDF): the port in
    'vjp' (torch double backward), 'pallas' (the SDF-VJP kernels' plain
    version on the CPU) and 'pallas_field' with FUSED_BG (the fused field
    and background kernels' plain versions) against the JAX step in 'vjp'
    (in f32 the per-sample and per-ray colour heads agree to rounding)."""
    cfg = setup_cfg()
    params = live_field_params(jax_init_field(jax.random.PRNGKey(0), jax_field_config(cfg)))
    batch = make_batch()
    fine = grid_host() if phase == "steady" else None
    want_aux, want_g = jax_step(cfg, params, batch, fine)
    got_aux, got_g = port_step(cfg, params, batch, fine, grad_mode)
    assert set(want_aux) == set(got_aux) >= {"loss", "color_loss", "normal_loss", "mask_error",
                                             "sfm_depth_loss", "psnr", "s_val"}
    for k, v in want_aux.items():
        tol = SCALAR_ATOL if k in ("psnr", "s_val") else LOSS_RTOL * abs(v)
        assert abs(got_aux[k] - v) <= tol, (k, got_aux[k], v)
    assert set(got_g) == set(want_g)
    errs = {k: rel_l2(got_g[k].numpy(), want_g[k].numpy()) for k in want_g}
    bad = {k: e for k, e in errs.items() if e > GRAD_REL_L2}
    assert not bad, bad
    sdf_names = [k for k in want_g if k.startswith("neuconw.sdf_net.")]
    assert all(float(want_g[k].abs().max()) > 0 for k in sdf_names)


@pytest.mark.parametrize("term", ["color", "eikonal"])
def test_foreground_gradient_reaches_sdf_net(term):
    """render_rays under autograd, 'vjp' mode: the gradient of the colour
    loss and of the eikonal term reaches every sdf_net parameter and equals
    JAX's. (Before the create_graph repair the foreground's sdf, feature and
    gradient were detached, and no sdf_net parameter got any.)"""
    from neuralrecon_w_tpu.rendering.renderer import render_rays as jax_render_rays
    from neuralrecon_w_tpu_torch.rendering.renderer import render_rays

    cfg = setup_cfg()
    params = live_field_params(jax_init_field(jax.random.PRNGKey(1), jax_field_config(cfg)))
    batch = make_batch(r=32, seed=1)
    mask = np.ones(32, np.float32)

    def value(res, rgbs, lib):
        if term == "eikonal":
            return res["gradient_error"]
        return lib.sum(lib.abs(res["color"] - rgbs))

    jfc, jrc = jax_field_config(cfg), jax_render_config(cfg, nerf_far_override=False)

    def jloss(p):
        res = jax_render_rays(p, jfc, jrc, JaxSceneInfo(jnp.zeros(3), jnp.asarray(2.0), jnp.eye(4)),
                              jnp.asarray(batch["rays"]), jnp.asarray(batch["ts"]),
                              jnp.asarray(batch["labels"]), jax.random.PRNGKey(0), 0.5,
                              ray_mask=jnp.asarray(mask))
        return value(res, jnp.asarray(batch["rgbs"]), jnp)

    want = params_from_jax(jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(params)))
    fc = config.field_config_from_cfg(cfg)
    model = field_from_jax(jax.tree.map(np.asarray, params), fc, "cpu")
    res = render_rays(model, fc, config.render_config_from_cfg(cfg, nerf_far_override=False),
                      SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4)),
                      torch.from_numpy(batch["rays"]), torch.from_numpy(batch["ts"]),
                      torch.from_numpy(batch["labels"]), None, 0.5,
                      ray_mask=torch.from_numpy(mask))
    value(res, torch.from_numpy(batch["rgbs"]), torch).backward()
    # d sdf / d x does not depend on the last layer's bias
    free = f"neuconw.sdf_net.lin{model.neuconw.sdf_net.n_layers - 1}.bias"
    for name, p in model.named_parameters():
        if name.startswith("neuconw.sdf_net.") and not (term == "eikonal" and name == free):
            assert p.grad is not None and float(p.grad.abs().max()) > 0, name
            assert rel_l2(p.grad.numpy(), want[name].numpy()) <= GRAD_REL_L2, name


def test_ray_mask_and_loss_terms_match_jax():
    from neuralrecon_w_tpu.training import loss_terms as jax_loss_terms
    from neuralrecon_w_tpu.training import ray_mask_from_labels as jax_ray_mask

    labels = np.array([0, 12, 2, 20, 12, 5, 116, 127], np.int32)
    ids = (12, 20, 127, 116)
    np.testing.assert_array_equal(ray_mask_from_labels(torch.from_numpy(labels), ids).numpy(),
                                  np.asarray(jax_ray_mask(jnp.asarray(labels), ids)))
    assert ray_mask_from_labels(torch.from_numpy(labels), ()).sum() == 8
    rng = np.random.default_rng(3)
    n = 16
    # the eikonal term's numerator and count, as render_rays returns them,
    # beside their quotient, JAX's gradient_error
    eikonal_sum, relax_sum = np.float32(2.59), np.float32(7.0)
    res = {"color": rng.random((n, 3)), "eikonal_sum": eikonal_sum, "relax_sum": relax_sum,
           "gradient_error": eikonal_sum / (relax_sum + np.float32(1e-5)),
           "ray_mask": (rng.random(n) > 0.3), "mask_error": rng.random((n, 1)),
           "sfm_depth_sq": rng.random(n), "sfm_depth_valid": (rng.random(n) > 0.5),
           "floor_normal_error": rng.random((n, 3)), "floor_count": np.float32(5.0)}
    res = {k: np.asarray(v, np.float32) for k, v in res.items()}
    rgbs = rng.random((n, 3)).astype(np.float32)
    cfg = setup_cfg()
    cfg.NEUCONW.FLOOR_NORMAL = True
    want = jax_loss_terms(jax_loss_config(cfg), {k: jnp.asarray(v) for k, v in res.items()},
                          jnp.asarray(rgbs))
    t_res = {k: torch.from_numpy(v) for k, v in res.items()}
    got = loss_terms(loss_config_from_cfg(cfg), t_res, torch.from_numpy(rgbs),
                     batch_counts(t_res))
    assert set(got) == set(want) == {"color_loss", "normal_loss", "mask_error", "sfm_depth_loss",
                                     "floor_normal_error", "loss"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


# each case's gradient scales: the second update clipped at GRAD_CLIP 0.99
# (the others below it); RAdam's eight cross its rectification (update 6)
GRAD_SCALES = {"adam": (0.1, 3.0, 0.05), "sgd": (0.1, 3.0, 0.05),
               "radam": (0.1, 3.0, 0.05, 0.2, 0.08, 0.15, 0.03, 0.12)}


@pytest.mark.parametrize("opt,sched", [("adam", "none"), ("adam", "cosine"), ("adam", "steplr"),
                                       ("adam", "poly"), ("sgd", "none"), ("radam", "none"),
                                       ("radam", "cosine"), ("radam", "steplr"),
                                       ("radam", "poly")])
def test_optimizer_matches_optax(opt, sched):
    """The same gradients through JAX make_optimizer and the port's over
    GRAD_SCALES[opt] updates, the second clipped at GRAD_CLIP 0.99; weight
    decay with the cosine schedule (AdamW; RAdam ignores it on both sides).
    RAdam's update runs jitted, as the JAX package runs it: XLA's float32
    power there is the correctly rounded one (eager jnp.power with an
    integer count is an ulp or two off, which moves ro by ~0.02 at t = 6)."""
    from neuralrecon_w_tpu.training import make_optimizer as jax_make_optimizer
    from neuralrecon_w_tpu_torch.training.schedule import make_optimizer

    cfg = get_cfg_defaults()
    cfg.TRAINER.OPTIMIZER, cfg.TRAINER.LR_SCHEDULER = opt, sched
    cfg.TRAINER.DECAY_STEP, cfg.TRAINER.DECAY_GAMMA = [1, 2], 0.5
    cfg.TRAINER.WEIGHT_DECAY = 0.01 if sched == "cosine" else 0
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in GRAD_SCALES[opt]]
    total = len(grads) + 1  # the schedules stay above 0 through the last update
    jopt, _ = jax_make_optimizer(cfg, 8192, total_steps=total)
    update = jax.jit(jopt.update) if opt == "radam" else jopt.update
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    spec, _ = make_optimizer(cfg, 8192, total_steps=total)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = spec.init(tp.values())
    for g in grads:
        upd, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("sched", ["none", "cosine", "steplr", "poly"])
def test_lr_schedules_match_optax(sched):
    from neuralrecon_w_tpu.training import make_lr_schedule as jax_schedule
    from neuralrecon_w_tpu.training import scaled_lr as jax_scaled_lr
    from neuralrecon_w_tpu_torch.training.schedule import make_lr_schedule, scaled_lr

    cfg = get_cfg_defaults()
    cfg.TRAINER.LR_SCHEDULER = sched
    cfg.TRAINER.DECAY_STEP = [10, 50]
    assert scaled_lr(cfg, 8192) == jax_scaled_lr(cfg, 8192) == pytest.approx(4e-3)
    cfg.TRAINER.LR = 3e-4
    assert scaled_lr(cfg, 123) == jax_scaled_lr(cfg, 123) == 3e-4
    for total in (0, 100):
        want, got = jax_schedule(cfg, 1e-3, total), make_lr_schedule(cfg, 1e-3, total)
        for count in (0, 1, 9, 10, 11, 50, 99, 100, 150):
            w = float(want(count)) if callable(want) else want
            g = got(count) if callable(got) else got
            assert g == pytest.approx(w, rel=1e-6, abs=1e-9), (total, count)


@pytest.mark.parametrize("n_cols", [11, 12])
def test_ray_pool_matches_jax(n_cols):
    from neuralrecon_w_tpu.datasets.cache import RayPool as JaxRayPool
    from neuralrecon_w_tpu_torch.datasets.cache import RayPool

    rng = np.random.default_rng(n_cols)
    rays = rng.random((100, n_cols)).astype(np.float32)
    rays[:, 8] = rng.integers(0, 9, 100)
    rays[:, 9] = rng.integers(0, 20, 100)
    rgbs = rng.random((100, 3)).astype(np.float32)
    mine, theirs = RayPool(rays, rgbs, seed=7), JaxRayPool(rays, rgbs, seed=7)
    assert len(mine) == len(theirs) and mine.epoch_batches(32) == theirs.epoch_batches(32) == 3
    for _ in range(5):  # past an epoch's end: a new permutation
        a, b = mine.next_batch(32), theirs.next_batch(32)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
