"""PyTorch port, the optimisers against optax: the captured step's update
(``Optimizer.graph_step``, its count and LR tensors) on CPU tensors, the
JAX optimiser state carried across (``tools/convert.state_from_jax``),
and the optimiser state through a checkpoint (``training/checkpoint.py``)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config  # noqa: E402
from neuralrecon_w_tpu.training import make_optimizer as jax_make_optimizer  # noqa: E402
from neuralrecon_w_tpu.training.step import TrainState as JaxTrainState  # noqa: E402
from neuralrecon_w_tpu.training.step import init_state as jax_init_state  # noqa: E402
from neuralrecon_w_tpu_torch.config import field_config_from_cfg, get_cfg_defaults  # noqa: E402
from neuralrecon_w_tpu_torch.models.neuconw import init_field  # noqa: E402
from neuralrecon_w_tpu_torch.tools.convert import (  # noqa: E402
    params_from_jax,
    state_from_jax,
)
from neuralrecon_w_tpu_torch.training.checkpoint import (  # noqa: E402
    load_field,
    restore_checkpoint,
    save_checkpoint,
)
from neuralrecon_w_tpu_torch.training.schedule import OPTIMIZERS, make_optimizer  # noqa: E402
from test_torch_train_step import GRAD_SCALES, setup_cfg  # noqa: E402

torch.set_num_threads(1)

# a JAX state after CARRY_AT updates, then as many more on each side: the
# count carried into RAdam's unrectified updates 4 and 5, then update 6
CARRY_AT = 3
# a checkpoint after update SAVE_AT of 2 x SAVE_AT, inside RAdam's first five
SAVE_AT = 4


@pytest.mark.parametrize("opt,sched,scale", [
    ("sgd", "none", 1.0), ("sgd", "cosine", 1.0), ("radam", "none", 1.0),
    ("radam", "steplr", 1.0), ("radam", "poly", 1.0), ("radam", "none", 1e-6)])
def test_graph_step_matches_optax(opt, sched, scale):
    """``graph_step`` after ``make_capturable`` (the LR a 0-d tensor, the
    update count a float64 tensor it advances), on CPU tensors, over
    GRAD_SCALES["radam"]'s 8 updates x ``scale`` (at 1 the second clipped
    at GRAD_CLIP; at 1e-6 sqrt(v_hat) is near eps, where eps's place in
    the rectified update shows), RAdam rectified from the sixth, against JAX
    make_optimizer's jitted update, within atol 1e-6; the host count stays
    the caller's."""
    cfg = get_cfg_defaults()
    cfg.TRAINER.OPTIMIZER, cfg.TRAINER.LR_SCHEDULER = opt, sched
    cfg.TRAINER.DECAY_STEP, cfg.TRAINER.DECAY_GAMMA = [1, 2], 0.5
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s * scale).astype(np.float32)
              for k, v in params.items()} for s in GRAD_SCALES["radam"]]
    total = len(grads) + 1
    jopt, _ = jax_make_optimizer(cfg, 8192, total_steps=total)
    update = jax.jit(jopt.update)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    spec, _ = make_optimizer(cfg, 8192, total_steps=total)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = spec.init(tp.values())
    topt.make_capturable()
    count_t = torch.zeros((), dtype=torch.float64)
    for g in grads:
        upd, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.graph_step(count_t)
    assert float(count_t) == len(grads) and topt.count == 0
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)


def field_grads(np_params, n: int, seed: int = 0) -> list:
    """n gradient trees shaped as the JAX field's parameters; every other
    one large enough for GRAD_CLIP to clip it."""
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda p, s=s: (rng.standard_normal(np.shape(p)) * s).astype(np.float32),
                         np_params) for s in (1e-3, 1e-2) * (n // 2) + (1e-3,) * (n % 2)]


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_state_from_jax_carries_the_optimizer(opt):
    """A JAX state after CARRY_AT updates of the field (SDF 4 x 64) carried
    across: the count, and CARRY_AT more updates on each side within atol
    1e-6 of JAX's parameters (Adam's and RAdam's moments, SGD's trace)."""
    cfg = setup_cfg()
    cfg.TRAINER.OPTIMIZER = opt
    jopt, _ = jax_make_optimizer(cfg, 64)
    jstate = jax_init_state(jax.random.PRNGKey(0), jax_field_config(cfg), jopt)
    update = jax.jit(jopt.update)
    grads = field_grads(jax.device_get(jstate.params), 2 * CARRY_AT)
    params, ost = jstate.params, jstate.opt_state
    for g in grads[:CARRY_AT]:
        upd, ost = update(g, ost, params)
        params = optax.apply_updates(params, upd)
    np_state = jax.device_get(JaxTrainState(params, ost, jnp.int32(CARRY_AT)))
    spec, _ = make_optimizer(cfg, 64)
    state, _ = state_from_jax(np_state, field_config_from_cfg(cfg), spec, device="cpu")
    assert state.optimizer.count == state.step == CARRY_AT
    assert len(state.optimizer.opt.state) == len(list(state.model.parameters()))
    for g in grads[CARRY_AT:]:
        upd, ost = update(g, ost, params)
        params = optax.apply_updates(params, upd)
        tg = params_from_jax(jax.device_get(g))
        for name, p in state.model.named_parameters():
            p.grad = tg[name].reshape(p.shape).clone()
        state.optimizer.step()
    want = params_from_jax(jax.device_get(params))
    got = state.model.state_dict()
    worst = max(float((got[k] - want[k].reshape(got[k].shape)).abs().max()) for k in want)
    assert worst <= 1e-6, worst


def torch_updates(model, optimizer, grads: list) -> None:
    for g in grads:
        for p, gp in zip(model.parameters(), g):
            p.grad = gp.clone()
        optimizer.step()


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_checkpoint_resume_matches_uninterrupted(opt, tmp_path):
    """A field and its optimiser saved after update SAVE_AT and restored
    (``load_field``, ``Optimizer.load_state_dict``) take the next SAVE_AT
    updates to the parameters, optimiser state and count of an
    uninterrupted run, bit for bit: RAdam stays unrectified through update
    5 and rectifies at 6 either way."""
    cfg = setup_cfg()
    cfg.TRAINER.OPTIMIZER = opt
    fc = field_config_from_cfg(cfg)
    spec, _ = make_optimizer(cfg, 64)
    gen = torch.Generator().manual_seed(3)
    whole = init_field(fc, torch.Generator().manual_seed(0), "cpu")
    grads = [[torch.randn(p.shape, generator=gen) * s for p in whole.parameters()]
             for s in (1e-3, 1e-2) * SAVE_AT]
    run = spec.init(whole.parameters())
    torch_updates(whole, run, grads)

    first = init_field(fc, torch.Generator().manual_seed(0), "cpu")
    opt1 = spec.init(first.parameters())
    torch_updates(first, opt1, grads[:SAVE_AT])
    path = save_checkpoint(str(tmp_path / f"step_{SAVE_AT}.ckpt"), first, SAVE_AT, opt1)
    saved = restore_checkpoint(path)["optimizer"]
    assert saved["name"] == opt and saved["count"] == SAVE_AT
    back = load_field(path, fc, "cpu")
    opt2 = spec.init(back.parameters())
    opt2.load_state_dict(saved)
    assert opt2.count == SAVE_AT
    torch_updates(back, opt2, grads[SAVE_AT:])
    assert opt2.count == run.count == 2 * SAVE_AT
    for (k, a), b in zip(whole.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = run.opt.state_dict()["state"], opt2.opt.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert sa[i].keys() == sb[i].keys()
        for k in sa[i]:
            assert torch.equal(sa[i][k].cpu(), sb[i][k].cpu()), (i, k)


def test_another_optimizers_state_raises():
    """Optimizer.load_state_dict refuses a state of another optimiser, by
    its name (RAdam's state has Adam's keys), and knows a file written
    before the name was kept by its state (SGD's momentum, else Adam's)."""
    cfg = setup_cfg()
    fc = field_config_from_cfg(cfg)
    model = init_field(fc, torch.Generator().manual_seed(0), "cpu")
    saved = {}
    for opt in OPTIMIZERS:
        cfg.TRAINER.OPTIMIZER = opt
        o = make_optimizer(cfg, 64)[0].init(model.parameters())
        torch_updates(model, o, [[torch.full_like(p, 1e-3) for p in model.parameters()]])
        saved[opt] = o.state_dict()
    for opt in OPTIMIZERS:
        cfg.TRAINER.OPTIMIZER = opt
        for other in OPTIMIZERS:
            o = make_optimizer(cfg, 64)[0].init(model.parameters())
            if other == opt:
                o.load_state_dict(saved[other])
                assert o.count == 1 and len(o.opt.state) == len(o.params)
                continue
            with pytest.raises(ValueError, match=f"holds {other!r} optimiser state"):
                o.load_state_dict(saved[other])
        unnamed = {k: v for k, v in saved[opt].items() if k != "name"}
        o = make_optimizer(cfg, 64)[0].init(model.parameters())
        if opt == "radam":  # such a file is Adam's
            with pytest.raises(ValueError, match="holds 'adam' optimiser state"):
                o.load_state_dict(unnamed)
        else:
            o.load_state_dict(unnamed)
            assert o.count == 1
