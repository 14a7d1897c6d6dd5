"""PyTorch port, field networks: parity with the JAX models on the same
parameters (carried over by params_from_jax) and the same inputs."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralrecon_w_tpu.config import get_cfg_defaults  # noqa: E402
from neuralrecon_w_tpu.models import field_background as jax_field_background  # noqa: E402
from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config  # noqa: E402
from neuralrecon_w_tpu.models import field_forward as jax_field_forward  # noqa: E402
from neuralrecon_w_tpu.models import init_field as jax_init_field  # noqa: E402
from neuralrecon_w_tpu_torch.config import field_config_from_cfg  # noqa: E402
from neuralrecon_w_tpu_torch.models import field_background, field_forward, field_sdf  # noqa: E402
from neuralrecon_w_tpu_torch.tools.convert import field_from_jax, init_field, params_from_jax  # noqa: E402
from test_torch_sdf_mlp import live_field_params  # noqa: E402

torch.set_num_threads(1)

# f32: both frameworks run the same f32 ops; only summation order differs
F32_ATOL = 1e-5
# bf16: the frameworks round at different points (XLA rounds each
# elementwise bf16 op, torch computes softplus / sums in f32 and rounds
# once), so outputs agree to a few bf16 ulps of values of order 1
BF16_ATOL = 2e-2


def small_cfg(act="float32", encode_a_bg=True):
    cfg = get_cfg_defaults()
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden = 64
    n.SDF_CONFIG.d_out = 65
    n.SDF_CONFIG.n_layers = 4
    n.SDF_CONFIG.skip_in = (2,)
    n.COLOR_CONFIG.d_feature = 64
    n.COLOR_CONFIG.d_hidden = 64
    n.COLOR_CONFIG.n_layers = 2
    n.N_VOCAB = 16
    n.ENCODE_A_BG = encode_a_bg
    cfg.TPU.FIELD_DTYPE = act
    return cfg


def make_pair(cfg, seed=0):
    params = live_field_params(jax_init_field(jax.random.PRNGKey(seed), jax_field_config(cfg)),
                               seed)
    np_params = jax.tree.map(np.asarray, params)
    fc = field_config_from_cfg(cfg)
    return params, field_from_jax(np_params, fc).requires_grad_(False), fc


def inputs(seed, r=8, s=6):
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((r * s, 3)) * 0.4).astype(np.float32)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    a = rng.standard_normal((r, 48)).astype(np.float32)
    pts4 = np.concatenate([pts, rng.uniform(0.1, 1.0, (r * s, 1))], -1).astype(np.float32)
    return pts, d, a, pts4, s


@pytest.mark.parametrize("act,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
def test_field_forward_matches_jax(act, atol):
    cfg = small_cfg(act)
    params, model, fc = make_pair(cfg)
    pts, d, a, _, s = inputs(1)
    jfc = jax_field_config(cfg)
    want = jax.jit(lambda *x: jax_field_forward(params, jfc, *x, s))(
        jnp.asarray(pts), jnp.asarray(d), jnp.asarray(a))
    with torch.no_grad():
        got = field_forward(model, fc, torch.from_numpy(pts), torch.from_numpy(d),
                            torch.from_numpy(a), s)
    for name, w, g in zip(["rgb", "inv_s", "sdf", "grad"], want, got):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=atol,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("act,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("encode_a_bg", [True, False])
def test_field_background_matches_jax(act, atol, encode_a_bg):
    cfg = small_cfg(act, encode_a_bg)
    params, model, fc = make_pair(cfg, seed=2)
    _, d, a, pts4, s = inputs(3)
    jfc = jax_field_config(cfg)
    want = jax.jit(lambda *x: jax_field_background(params, jfc, *x, s))(
        jnp.asarray(pts4), jnp.asarray(d), jnp.asarray(a))
    with torch.no_grad():
        got = field_background(model, fc, torch.from_numpy(pts4), torch.from_numpy(d),
                               torch.from_numpy(a), s)
    for name, w, g in zip(["density", "rgb"], want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0, err_msg=name)


def test_field_sdf_flagship_width_matches_jax():
    """512 wide, 8 layers, skip at 4: the brandenburg_gate SDF network."""
    from neuralrecon_w_tpu.models import field_sdf as jax_field_sdf

    cfg = get_cfg_defaults()
    cfg.NEUCONW.N_VOCAB = 16
    params, model, fc = make_pair(cfg, seed=4)
    pts = (np.random.default_rng(5).standard_normal((256, 3)) * 0.5).astype(np.float32)
    jfc = jax_field_config(cfg)
    want = np.asarray(jax.jit(lambda x: jax_field_sdf(params, jfc, x))(jnp.asarray(pts)))
    with torch.no_grad():
        got = field_sdf(model, fc, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("encode_a_bg", [True, False])
def test_params_from_jax_loads_strictly(encode_a_bg):
    """Every exported tensor lands in the module tree under the reference
    checkpoint's name; only the two dead reference entries are dropped."""
    from neuralrecon_w_tpu.tools.convert_torch_ckpt import export_state_dict

    cfg = small_cfg(encode_a_bg=encode_a_bg)
    params, model, _ = make_pair(cfg)
    np_params = jax.tree.map(np.asarray, params)
    sd = params_from_jax(np_params)
    exported = export_state_dict(np_params)
    dropped = set(exported) - set(sd)
    want_dropped = {"neuconw.xyz_encoding_final.weight", "neuconw.xyz_encoding_final.bias"}
    if encode_a_bg:
        want_dropped |= {"nerf.views_linears.0.weight", "nerf.views_linears.0.bias"}
    assert dropped == want_dropped
    state = model.state_dict()
    assert set(state) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy(), err_msg=k)
    assert state["neuconw.sdf_net.lin0.weight_v"].shape == (64, 39)
    assert state["neuconw.deviation_network.variance"].shape == ()


def test_init_field_geometric_sphere():
    """The torch-side init draws the JAX package's geometric init: at
    init the SDF approximates |x| - bias (a sphere of radius 0.5) as
    closely as the JAX init does (other random numbers, same law)."""
    from neuralrecon_w_tpu.models import field_sdf as jax_field_sdf

    cfg = get_cfg_defaults()
    cfg.NEUCONW.N_VOCAB = 16
    fc = field_config_from_cfg(cfg)
    model = init_field(fc, torch.Generator().manual_seed(0)).requires_grad_(False)
    pts = (np.random.default_rng(6).standard_normal((256, 3)) * 0.4).astype(np.float32)
    sphere = np.linalg.norm(pts, axis=-1) - 0.5
    err = np.abs(field_sdf(model, fc, torch.from_numpy(pts)).numpy() - sphere)
    jfc = jax_field_config(cfg)
    jax_params = jax_init_field(jax.random.PRNGKey(0), jfc)
    jax_err = np.abs(np.asarray(jax.jit(lambda x: jax_field_sdf(jax_params, jfc, x))(
        jnp.asarray(pts))) - sphere)
    assert err.mean() < jax_err.mean() + 0.1 and err.max() < 2 * jax_err.max()
    # same structural zeros as the JAX init: PE tail at layer 0 and the skip
    sd = model.state_dict()
    assert float(sd["neuconw.sdf_net.lin0.weight_v"][:, 3:].abs().max()) == 0.0
    assert float(sd["neuconw.sdf_net.lin4.weight_v"][:, -36:].abs().max()) == 0.0
    assert float(sd["neuconw.deviation_network.variance"]) == pytest.approx(fc.s_init)
