"""PyTorch port, K6 (the fused field forward): the plain version, which the
kernel is held to on the card, against the JAX Pallas kernel in interpret
mode and against the JAX field's own forward, on the same weights
(carried over by params_from_jax) and inputs."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralrecon_w_tpu.config import get_cfg_defaults  # noqa: E402
from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config  # noqa: E402
from neuralrecon_w_tpu.models import field_forward as jax_field_forward  # noqa: E402
from neuralrecon_w_tpu.models import init_field as jax_init_field  # noqa: E402
from neuralrecon_w_tpu.ops.pallas_field import fused_field_forward as jax_fused  # noqa: E402
from neuralrecon_w_tpu_torch.config import field_config_from_cfg  # noqa: E402
from neuralrecon_w_tpu_torch.ops import field_forward as ff  # noqa: E402
from neuralrecon_w_tpu_torch.tools.convert import field_from_jax  # noqa: E402
from test_torch_sdf_mlp import live_field_params  # noqa: E402

torch.set_num_threads(1)

# f32: the JAX test's own tolerances (tests/test_pallas.py:104-106)
SDF_ATOL, GRAD_ATOL, RGB_ATOL = 1e-4, 1e-3, 1e-4
# bf16: both sides round at the same places; a value summed in another
# order can round to the neighbouring bf16 value, per output rel-L2
BF16_REL = 2e-2


def small_cfg(act="float32", d_hidden=64, n_layers=4, skip=(2,)):
    cfg = get_cfg_defaults()
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out = d_hidden, d_hidden + 1
    n.SDF_CONFIG.n_layers, n.SDF_CONFIG.skip_in = n_layers, skip
    n.COLOR_CONFIG.d_feature = d_hidden
    n.COLOR_CONFIG.d_hidden, n.COLOR_CONFIG.n_layers = 64, 2
    n.N_VOCAB = 16
    cfg.TPU.FIELD_DTYPE = act
    return cfg


def make_pair(cfg, seed=0):
    params = live_field_params(jax_init_field(jax.random.PRNGKey(seed), jax_field_config(cfg)),
                               seed)
    fc = field_config_from_cfg(cfg)
    return params, field_from_jax(jax.tree.map(np.asarray, params), fc, "cpu"), fc


def inputs(params, n=200, seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n, 3)) * 0.4).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    a = np.asarray(params["embedding_a"])[rng.integers(0, 16, n)]
    return pts, dirs, a


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def run_both(cfg, seed=0, n=200):
    params, model, fc = make_pair(cfg, seed)
    pts, dirs, a = inputs(params, n, seed)
    jfc = jax_field_config(cfg)
    want = jax_fused(params, jfc, jnp.asarray(pts), jnp.asarray(dirs), jnp.asarray(a), tile=64,
                     interpret=True)
    with torch.no_grad():
        got = ff.fused_field_forward(model, fc, torch.from_numpy(pts), torch.from_numpy(dirs),
                                     torch.from_numpy(a))
    return [g.numpy() for g in got], [np.asarray(w) for w in want], (params, jfc, pts, dirs, a)


@pytest.mark.parametrize("d_hidden,n_layers,skip", [(64, 4, (2,)), (256, 8, (4,))])
def test_plain_matches_pallas_interpret_f32(d_hidden, n_layers, skip):
    (rgb, sdf, grad), (w_rgb, w_sdf, w_grad), _ = run_both(
        small_cfg("float32", d_hidden, n_layers, skip), n=128 if d_hidden > 64 else 200)
    assert rgb.shape == (len(sdf), 3) and grad.shape == (len(sdf), 3)
    np.testing.assert_allclose(sdf, w_sdf, atol=SDF_ATOL)
    np.testing.assert_allclose(grad, w_grad, atol=GRAD_ATOL)
    np.testing.assert_allclose(rgb, w_rgb, atol=RGB_ATOL)


def test_plain_matches_pallas_interpret_bf16():
    (rgb, sdf, grad), (w_rgb, w_sdf, w_grad), _ = run_both(small_cfg("bfloat16"), seed=1)
    for name, g, w in (("rgb", rgb, w_rgb), ("sdf", sdf, w_sdf), ("grad", grad, w_grad)):
        assert rel_l2(g, w) <= BF16_REL, name


def test_plain_matches_jax_field_forward_f32():
    """The plain version is the field's forward: JAX's field_forward (its
    autodiff gradient, its colour head) on the same weights."""
    (rgb, sdf, grad), _, (params, jfc, pts, dirs, a) = run_both(small_cfg("float32"), seed=2)
    w_rgb, _, w_sdf, w_grad = jax_field_forward(params, jfc, jnp.asarray(pts),
                                                jnp.asarray(dirs), jnp.asarray(a))
    np.testing.assert_allclose(sdf, np.asarray(w_sdf), atol=SDF_ATOL)
    np.testing.assert_allclose(grad, np.asarray(w_grad), atol=GRAD_ATOL)
    np.testing.assert_allclose(rgb, np.asarray(w_rgb), atol=RGB_ATOL)


def test_pack_color_weights_layout():
    """Layers xyz_final, static0, static1, lin0.. padded to multiples of
    16 with zeros; the static head's 64 + 27 + 48 input and lin0's
    3 + 3 + 128 are the widths the kernel splits and stages."""
    _, model, fc = make_pair(small_cfg("bfloat16"))
    cp = ff.pack_color_weights(model.neuconw.color_net, fc.color, fc.act_dtype)
    assert cp.w.dtype == torch.bfloat16 and cp.b.dtype == torch.float32
    assert cp.n_static == 2 and cp.multires_view == 4
    assert cp.k == (64, 64 + 27 + 48, 128, 134, 64, 64)
    assert cp.n == (64, 128, 128, 64, 64, 3)
    assert cp.kpad == (64, 144, 128, 144, 64, 64)
    assert all(o % 8 == 0 for o in cp.w_off)
    for i in range(len(cp.k)):
        npad = (cp.n[i] + 15) // 16 * 16
        full = cp.w[cp.w_off[i]:cp.w_off[i] + npad * cp.kpad[i]].view(npad, cp.kpad[i])
        assert float(full[cp.n[i]:].abs().sum()) == 0.0
        assert float(full[:, cp.k[i]:].abs().sum()) == 0.0
    w, b = cp.layer(5)  # the weight-normed last layer: the effective weight
    want = model.neuconw.color_net.lin2.effective_weight().to(torch.bfloat16)
    assert torch.equal(w, want) and b.shape == (3,)


def test_wrapper_takes_no_other_path():
    """CPU tensors take the plain version and count no launch; a tensor
    elsewhere reaches the kernel path, which checks its device, and never
    the plain version."""
    params, model, fc = make_pair(small_cfg("float32"))
    pts, dirs, a = (torch.from_numpy(x) for x in inputs(params, 32))
    before = ff.fused_field_forward.launches
    with torch.no_grad():
        got = ff.fused_field_forward(model, fc, pts, dirs, a)
        want = ff.field_forward_plain(ff.pack_field(model, fc), pts, dirs, a)
    assert ff.fused_field_forward.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    meta = [t.to("meta") for t in (pts, dirs, a)]
    with pytest.raises(ValueError):
        ff.fused_field_forward(model, fc, *meta)
