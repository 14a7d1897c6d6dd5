"""PyTorch port, tensor parallelism over the ``model`` axis
(``neuralrecon_w_tpu_torch/parallel/tensor.py``): ``field_param_specs``
against the JAX package's leaf by leaf; on gloo ranks on the CPU, started by
``parallel.mesh.spawn``: the four collectives and ``tp_linear`` under
``gradcheck`` and ``gradgradcheck``, the library all-reduce's doubled
gradient, ``shard_field`` / ``gather_field``, d sdf / d x and the eikonal
gradient of a split SDF net; training steps of a field split over two model
ranks against the JAX step on the same weights and batch and against one
rank ('vjp', 'pallas' with the sampler's kernels, 'fwd'), a (2 data x 2
model) step against JAX's ``jit_train_step`` with ``param_specs``, and the
split render."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from neuralrecon_w_tpu.config import get_cfg_defaults  # noqa: E402
from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config  # noqa: E402
from neuralrecon_w_tpu.models import init_field as jax_init_field  # noqa: E402
from neuralrecon_w_tpu.parallel import make_mesh  # noqa: E402
from neuralrecon_w_tpu.parallel import mesh as jax_mesh  # noqa: E402
from neuralrecon_w_tpu.rendering import render_config_from_cfg as jax_render_config  # noqa: E402
from neuralrecon_w_tpu.rendering.renderer import SceneInfo as JaxSceneInfo  # noqa: E402
from neuralrecon_w_tpu.training import init_state as jax_init_state  # noqa: E402
from neuralrecon_w_tpu.training import jit_train_step  # noqa: E402
from neuralrecon_w_tpu.training import loss_config_from_cfg as jax_loss_config  # noqa: E402
from neuralrecon_w_tpu.training import make_optimizer as jax_make_optimizer  # noqa: E402
from neuralrecon_w_tpu.training import make_train_step as jax_make_train_step  # noqa: E402
from neuralrecon_w_tpu_torch import config  # noqa: E402
from neuralrecon_w_tpu_torch.models.neuconw import NeuconWField  # noqa: E402
from neuralrecon_w_tpu_torch.parallel import mesh  # noqa: E402
from neuralrecon_w_tpu_torch.parallel import tensor as tp  # noqa: E402
from neuralrecon_w_tpu_torch.rendering.renderer import SceneInfo  # noqa: E402
from neuralrecon_w_tpu_torch.testing import ranks  # noqa: E402
from neuralrecon_w_tpu_torch.tools.convert import field_from_jax, params_from_jax  # noqa: E402
from neuralrecon_w_tpu_torch.training.schedule import make_optimizer  # noqa: E402
from test_torch_parallel import SCENE, parallel_cfg, port_setup, uneven_batch  # noqa: E402
from test_torch_sdf_mlp import live_field_params  # noqa: E402
from test_training import tiny_cfg  # noqa: E402

torch.set_num_threads(2)

# JAX's own TP bounds (tests/test_training.py:_run_tp_equals_dp)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4
# the split net's gradients against one rank's: the same arithmetic in
# other blocks, so f32 rounding apart
GRAD_ATOL = 1e-6
EIKONAL_ATOL = 1e-6
RENDER_TOL = 2e-5  # tests/test_render_cli.py:_assert_sharded_parity's
CODE = {P(None, jax_mesh.MODEL_AXIS): "col", P(jax_mesh.MODEL_AXIS, None): "row",
        P(jax_mesh.MODEL_AXIS): "col", P(): None}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two threads a rank: the spawned ranks read it at start-up."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        yield


def run_ranks(fn, spec, tmp_path, suffix, n=2, n_model=2):
    out = str(tmp_path / ("rank{rank}" + suffix))
    mesh.spawn(fn, n, (n, n_model, mesh.free_coordinator(), spec, out))
    return [torch.load(out.format(rank=r), weights_only=False) for r in range(n)]


def flagship_cfg():
    cfg = get_cfg_defaults()
    cfg.NEUCONW.N_VOCAB = 5000  # the flagship vocab (the defaults ship 1500)
    assert cfg.NEUCONW.SDF_CONFIG.d_out == 513
    return cfg


def jax_specs_by_name(cfg, n_model: int) -> dict:
    """JAX's field_param_specs over make_mesh(n_model=n_model), by the
    port's state-dict names (each spec coded as the value of its leaf, the
    leaves then carried through tools/convert's names and layouts)."""
    params = jax_init_field(jax.random.PRNGKey(0), jax_field_config(cfg))
    specs = jax_mesh.field_param_specs(make_mesh(n_model=n_model), params)
    keys = list(CODE)
    coded = jax.tree.map(lambda s, p: np.full(p.shape, keys.index(s), np.float32), specs, params,
                         is_leaf=lambda x: isinstance(x, P))
    got = params_from_jax(coded)
    for k, v in got.items():
        assert torch.all(v == v.reshape(-1)[0]), k
    return {k: CODE[keys[int(v.reshape(-1)[0])]] for k, v in got.items()}


@pytest.mark.parametrize("cfg_fn,n_model", [(tiny_cfg, 2), (tiny_cfg, 3), (tiny_cfg, 4),
                                            (flagship_cfg, 2)],
                         ids=["tiny-2", "tiny-3", "tiny-4", "flagship-2"])
def test_field_param_specs_match_jax(cfg_fn, n_model):
    """The port's rule names every parameter as JAX's does (the embedding's
    P(model) is "vocab"): column, row, or whole where a leaf divides on
    neither dim (over 3 ranks most of the tiny config's). Over 2 ranks,
    JAX's own asserts: more than 4 column weights, the row-split SDF head
    (65 / 513 wide), the 5000-row table split by vocab."""
    cfg = cfg_fn()
    model = NeuconWField(config.field_config_from_cfg(cfg), "cpu")
    got = mesh.field_param_specs(n_model, model)
    want = jax_specs_by_name(cfg, n_model)
    want["embedding_a.weight"] = want["embedding_a.weight"] and "vocab"
    assert got == want
    assert set(mesh.field_param_specs(1, model).values()) == {None}
    if n_model == 3:
        assert None in got.values() and "row" in got.values()
    if n_model != 2:
        return
    assert sum(1 for k, s in got.items() if s == "col" and k.endswith("weight_v")) > 4
    assert got["neuconw.sdf_net.lin%d.weight_v" % (model.neuconw.sdf_net.n_layers - 1)] == "row"
    if cfg.NEUCONW.N_VOCAB == 5000:
        assert got["embedding_a.weight"] == "vocab"


def live_state(cfg, seed=0):
    """The JAX package's initial field with its SDF made live, as numpy."""
    params = live_field_params(jax_init_field(jax.random.PRNGKey(seed), jax_field_config(cfg)))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    """tp_check_rank on two model ranks: the float64 gradient checks, the
    library all-reduce, the round trip, the split SDF net's eikonal term."""
    cfg = parallel_cfg()
    fc = config.field_config_from_cfg(cfg)
    spec = {"fc": fc, "state_dict": field_from_jax(live_state(cfg), fc, "cpu").state_dict(),
            "pts": (np.random.default_rng(0).random((64, 3)) * 1.6 - 0.8).astype(np.float32)}
    out = str(tmp_path_factory.mktemp("checks") / "rank{rank}.pt")
    mesh.spawn(ranks.tp_check_rank, 2, (2, mesh.free_coordinator(), spec, out))
    return [torch.load(out.format(rank=r), weights_only=False) for r in range(2)]


@pytest.mark.parametrize("collective", ["copy", "reduce", "gather", "split"])
def test_collective_is_differentiable_twice(checks, collective):
    """Each collective, in both of the pairs it forms with a conjugate
    (whole input to whole output, each rank's part scaled apart), passes
    gradcheck and gradgradcheck in float64 on both ranks."""
    for rec in checks:
        pairs = {k: v for k, v in rec["checks"].items() if collective in k}
        assert len(pairs) == 2
        assert all(ok == (True, True) for ok in pairs.values()), (rec["rank"], pairs)


@pytest.mark.parametrize("kind", ["col", "row"])
@pytest.mark.parametrize("norm", ["wn", "plain"])
def test_tp_linear_is_differentiable_twice(checks, kind, norm):
    """tp_linear over two column blocks of its input, scaled (the SDF
    skip's form), column- and row-split, weight-normed and plain: gradcheck
    and gradgradcheck in float64 against the whole layer's inputs."""
    for rec in checks:
        assert rec["checks"][(kind, norm)] == (True, True), rec["rank"]


def test_library_all_reduce_multiplies_gradients(checks):
    """The negative control: torch.distributed.nn's all_reduce in reduce's
    place (its backward all-reduces again) gives a row-split layer's input
    and weight gradients twice what reduce gives, on two model ranks."""
    for rec in checks:
        np.testing.assert_allclose(rec["library_ratio"], 2.0, rtol=1e-12)


def test_shard_then_gather_is_identity(checks):
    for rec in checks:
        assert rec["roundtrip_equal"]


def test_eikonal_gradient_under_tp(checks):
    """d sdf / d x of the split SDF net (column layers, the column-split
    skip, the 65-wide head split by rows) and the eikonal term's gradient of
    every SDF parameter (the double backward through the collectives), each
    against the whole net's."""
    for rec in checks:
        assert rec["dsdf_dx_err"] <= EIKONAL_ATOL, rec["dsdf_dx_err"]
        assert rec["eikonal_grad_err"] <= EIKONAL_ATOL, rec["eikonal_grad_err"]


def kernel_cfg(cfg, grad_mode):
    """cfg in ``grad_mode``: the port's fc and rcfg; in the kernel modes the
    sampler through K1 / K2 (their plain versions on the CPU), and with
    'pallas_field' the fused background (K8 / K9)."""
    cfg = cfg.clone()
    kernels = grad_mode != "fwd"
    cfg.TPU.SDF_GRAD_MODE = grad_mode
    cfg.TPU.FUSED_SAMPLER_SDF = kernels
    cfg.TPU.FUSED_BG = grad_mode == "pallas_field"
    fc = config.field_config_from_cfg(cfg)
    rcfg = config.render_config_from_cfg(cfg)
    assert fc.grad_mode == grad_mode and rcfg.fused_sampler_sdf == kernels
    assert fc.bg_mode == ("pallas" if grad_mode == "pallas_field" else "xla")
    return fc, rcfg


def step_spec(cfg, np_params, batch, runs):
    fc, rcfg, lcfg, mask_ids = port_setup(cfg)
    return {"fc": fc, "rcfg": rcfg, "lcfg": lcfg, "anneal_end": 10, "mask_ids": mask_ids,
            "optimizer": make_optimizer(cfg, 2048)[0], "batch": batch, "scene": SCENE,
            "device": "cpu", "state_dict": field_from_jax(np_params, fc, "cpu").state_dict(),
            "runs": runs}


def jax_step(cfg, params, batch, mesh_=None, param_specs=None):
    """One JAX step (Adam, as the port's optimiser): jitted alone, or over
    ``mesh_`` with ``param_specs``. Returns (loss, the port's state dict)."""
    jfc = jax_field_config(cfg)
    opt, _ = jax_make_optimizer(cfg, 2048, total_steps=0)
    state0 = jax_init_state(jax.random.PRNGKey(0), jfc, opt)._replace(params=params)
    mask_ids = port_setup(cfg)[3]
    step = jax_make_train_step(jfc, jax_render_config(cfg), jax_loss_config(cfg), opt, 10,
                               mask_ids)
    scene = JaxSceneInfo(*(jnp.asarray(v, jnp.float32) for v in SCENE))
    args = (state0, scene, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1),
            None, None)
    if mesh_ is None:
        s, aux = jax.jit(step)(*args)
    else:
        s, aux = jit_train_step(step, mesh_, donate=False, param_specs=param_specs)(*args)
    return float(aux["loss"]), params_from_jax(jax.tree.map(np.asarray, s.params))


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """From one live initialisation and the fixed batch: JAX's jitted step;
    the port on two model ranks (one data shard) and on one rank, in 'vjp'
    (one step, and three on the same batch), 'pallas' and 'pallas_field'
    with FUSED_BG (the sampler's kernels too) and 'fwd'."""
    cfg = parallel_cfg()
    params = live_field_params(jax_init_field(jax.random.PRNGKey(0), jax_field_config(cfg)))
    np_params = jax.tree.map(np.asarray, params)
    batch = uneven_batch()
    want = jax_step(cfg, params, batch)
    runs = [{"label": "vjp", "fc": config.field_config_from_cfg(cfg), "n_steps": 1},
            {"label": "vjp3", "fc": config.field_config_from_cfg(cfg), "n_steps": 3}]
    for mode in ("pallas", "pallas_field", "fwd"):
        fc, rcfg = kernel_cfg(cfg, mode)
        runs.append({"label": mode, "fc": fc, "rcfg": rcfg, "n_steps": 1})
    spec = step_spec(cfg, np_params, batch, runs)
    got = run_ranks(ranks.tp_step_rank, spec, tmp_path_factory.mktemp("tp"), ".pt")
    one = ranks.tp_step(spec)
    return want, got, one


def assert_state_close(got: dict, want: dict, atol: float):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


def test_tp_step_matches_jax(tp_runs):
    """A 1 x 2 step in f32: the loss within rtol 1e-5 of JAX's step on the
    same weights and batch, every parameter (gathered) within 1e-4; both
    ranks the same loss and the same whole field."""
    (want_loss, want_params), got, _ = tp_runs
    for rec in got:
        (loss,) = rec["vjp"]["losses"]
        assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
        assert_state_close(rec["vjp"]["params"], want_params, PARAM_ATOL)
    a, b = (rec["vjp"] for rec in got)
    assert a["losses"] == b["losses"]
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


def test_tp_gradient_matches_one_rank(tp_runs):
    """Each rank's gradient, gathered, is the unsplit field's: Adam's first
    update does not see a gradient's scale, this does. A parameter split
    between the ranks would show a missing or a doubled part."""
    _, got, one = tp_runs
    for rec in got:
        assert_state_close(rec["vjp"]["grads"], one["vjp"]["grads"], GRAD_ATOL)


def test_tp_whole_parameters_bit_equal_across_ranks(tp_runs):
    """The parameters both ranks hold whole (the row-split layers' g and
    bias, the variance) are bit for bit equal after three steps, and so
    were their gradients before their sync; at least one such leaf per
    kind is there."""
    _, got, _ = tp_runs
    a, b = (rec["vjp3"] for rec in got)
    assert a["whole_digests"] == b["whole_digests"]
    assert a["pre_sync_digests"] == b["pre_sync_digests"]
    names = set(a["whole_digests"])
    assert "neuconw.deviation_network.variance" in names
    assert {"neuconw.sdf_net.lin4.bias", "neuconw.sdf_net.lin4.weight_g"} <= names


def test_tp_three_steps_match_one_rank(tp_runs):
    """Three steps on the same batch: each step's loss within rtol 1e-5 of
    one rank's, the parameters within 1e-4."""
    _, got, one = tp_runs
    for rec in got:
        np.testing.assert_allclose(rec["vjp3"]["losses"], one["vjp3"]["losses"], rtol=LOSS_RTOL)
        assert_state_close(rec["vjp3"]["params"], one["vjp3"]["params"], PARAM_ATOL)


@pytest.mark.parametrize("mode", ["pallas", "pallas_field", "fwd"])
def test_tp_kernel_modes_match_one_rank(tp_runs, mode):
    """'pallas' (K3-K5), 'pallas_field' with FUSED_BG (K6-K9, K5) and the
    sampler's K1 / K2, through their plain versions on gathered weights,
    and 'fwd' (forward mode on gathered weights) on two model ranks: the
    loss and the parameters of one rank's step, the gradient within
    1e-6."""
    _, got, one = tp_runs
    for rec in got:
        r, o = rec[mode], one[mode]
        np.testing.assert_allclose(r["losses"], o["losses"], rtol=LOSS_RTOL)
        assert_state_close(r["params"], o["params"], PARAM_ATOL)
        assert_state_close(r["grads"], o["grads"], GRAD_ATOL)
    assert not any(rec["foreign_modules"] for rec in got)


def test_two_by_two_step_matches_jax_param_specs(tmp_path):
    """Four ranks, 2 data x 2 model (rank = data_rank * 2 + model_rank, as
    make_mesh lays the devices out): one step on the data halves of the
    fixed batch (which differ in every count the loss divides by) against
    JAX's jit_train_step over make_mesh(n_data=2, n_model=2) with
    field_param_specs; the loss within rtol 1e-5, the parameters within
    1e-4, every rank the same loss and whole field."""
    cfg = parallel_cfg()
    params = live_field_params(jax_init_field(jax.random.PRNGKey(0), jax_field_config(cfg)))
    batch = uneven_batch()
    m = make_mesh(n_data=2, n_model=2)
    want_loss, want_params = jax_step(cfg, params, batch, m,
                                      jax_mesh.field_param_specs(m, params))
    spec = step_spec(cfg, jax.tree.map(np.asarray, params), batch,
                     [{"label": "vjp", "fc": config.field_config_from_cfg(cfg), "n_steps": 1}])
    got = run_ranks(ranks.tp_step_rank, spec, tmp_path, ".pt", n=4)
    assert [(r["data_rank"], r["model_rank"]) for r in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for rec in got:
        (loss,) = rec["vjp"]["losses"]
        assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
    assert_state_close(got[0]["vjp"]["params"], want_params, PARAM_ATOL)
    for rec in got[1:]:
        assert rec["vjp"]["losses"] == got[0]["vjp"]["losses"]
        assert all(torch.equal(rec["vjp"]["params"][k], v)
                   for k, v in got[0]["vjp"]["params"].items())


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
def test_render_image_with_model_axis_matches_one_rank(tmp_path, split):
    """render_image through a (1 data x 2 model) group, the counterpart of
    tests/test_render_cli.py's (data 4, model 2) render: the model ranks
    render the same rays. A whole field renders bit for bit as one rank's;
    a split one within that test's 2e-5."""
    from neuralrecon_w_tpu_torch.training.step import make_render_fn
    from neuralrecon_w_tpu_torch.training.validation import render_image

    cfg = parallel_cfg()
    fc, rcfg, _, _ = port_setup(cfg)
    model = field_from_jax(live_state(cfg, seed=2), fc, "cpu").eval().requires_grad_(False)
    batch = uneven_batch(seed=3)
    wh = (8, 7)
    rays, ts, labels = batch["rays"][:56], batch["ts"][:56], np.zeros(56, np.int32)
    spec = {"fc": fc, "rcfg": rcfg, "state_dict": model.state_dict(), "rays": rays, "ts": ts,
            "labels": labels, "wh": wh, "chunk": 32, "scene": SCENE, "device": "cpu",
            "split": split}
    out = str(tmp_path / "rank{rank}.npz")
    mesh.spawn(ranks.tp_render_rank, 2, (2, 2, mesh.free_coordinator(), spec, out))
    got = [np.load(out.format(rank=r)) for r in range(2)]
    scene = SceneInfo(*(torch.as_tensor(v, dtype=torch.float32) for v in SCENE))
    want = render_image(make_render_fn(fc, rcfg), model, scene, rays, ts, labels, wh, 32)
    for g in got:
        for k in ("color", "depth", "normal"):
            if split:
                np.testing.assert_allclose(g[k], want[k], rtol=RENDER_TOL, atol=RENDER_TOL,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], want[k], err_msg=k)
    for k in ("color", "depth", "normal"):
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)


def test_scan_dispatch_refuses_a_split_field():
    """make_scan_train_fn's run (and a captured frame) takes a whole field:
    a gloo collective cannot be captured, and JAX's scan takes one data
    shard and no model axis."""
    from neuralrecon_w_tpu_torch.training.step import TrainState, make_scan_train_fn

    cfg = parallel_cfg()
    fc, rcfg, lcfg, mask_ids = port_setup(cfg)
    model = NeuconWField(fc, "cpu")
    model.embedding_a.weight.tp = tp.Split("vocab", 0, tp.Axis(2, 0, None))
    run = make_scan_train_fn(fc, rcfg, lcfg, 10, mask_ids, 8, 2)
    state = TrainState(model, make_optimizer(cfg, 8)[0].init(model.parameters()))
    data = {k: torch.as_tensor(v) for k, v in uneven_batch().items()}
    with pytest.raises(ValueError, match="split over a model axis"):
        run(state, SceneInfo(*(torch.as_tensor(v, dtype=torch.float32) for v in SCENE)), data)


def test_trainer_refuses_a_model_axis(tmp_path):
    """The Trainer (train_cli) takes a data group only: a model axis is a
    library path, as in the JAX package, whose Trainer takes a data mesh."""
    from types import SimpleNamespace

    from neuralrecon_w_tpu_torch.training.loop import Trainer, TrainerConfig

    group = SimpleNamespace(device=torch.device("cpu"), n_local=2, n_model=2)
    with pytest.raises(ValueError, match="a model axis is not one"):
        Trainer(parallel_cfg(), TrainerConfig(batch_size=8, exp_name="tp",
                                              save_dir=str(tmp_path)), group=group)
