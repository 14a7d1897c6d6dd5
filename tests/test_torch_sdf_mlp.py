"""PyTorch port, K1 (fused SDF MLP): the plain version, which the kernel is
held to on the card, against the JAX Pallas kernels in interpret mode."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralrecon_w_tpu.models.sdf import init_sdf  # noqa: E402
from neuralrecon_w_tpu.ops.pallas_mlp import fused_field_sdf as jax_fused_field_sdf  # noqa: E402
from neuralrecon_w_tpu.ops.pallas_mlp import fused_sdf_head as jax_fused_sdf_head  # noqa: E402
from neuralrecon_w_tpu_torch.models.sdf import SDFNetwork  # noqa: E402
from neuralrecon_w_tpu_torch.ops.sdf_mlp import (  # noqa: E402
    fused_field_sdf,
    fused_sdf_head,
    pack_sdf_weights,
)

torch.set_num_threads(1)

ATOL = RTOL = 1e-5  # f32 on both sides; summation order only


def sdf_cfg(d_hidden, n_layers, skip, scale=1.0):
    return dict(d_in=3, d_out=d_hidden + 1, d_hidden=d_hidden, n_layers=n_layers,
                skip_in=skip, multires=6, bias=0.5, scale=scale, geometric_init=True,
                weight_norm=True, inside_outside=False)


def live_sdf_params(params, seed=0, eps=0.02):
    """SDF parameters in which every input reaches the output. The
    geometric init zeroes layer 0's sin / cos columns, the PE half of the
    skip input and every hidden bias, and makes the last layer nearly
    constant, so there the two sides would only multiply zeros. Seeded
    noise on every weight (eps times the init's scale) and bias (eps)
    takes that away: it moves sdf by ~0.1 yet keeps the field's gradient
    of order 1, the magnitude the bf16 bounds are stated for. At 0.05 the
    JAX package's own Pallas and jnp samplers already part by 8e-4 on a
    ray (a small cdf step amplifies f32 rounding), past the sampler's
    1e-4 bound; at 0.02 they agree to 5e-6."""
    rng = np.random.default_rng(seed)
    last = f"lin{len(params) - 1}"
    out = {}
    for name, p in params.items():
        v, b = np.asarray(p["v"]), np.asarray(p["b"])
        d_in, d_out = v.shape
        sd = eps / np.sqrt(d_in) if name == last else eps * np.sqrt(2.0 / d_out)
        out[name] = {"v": (v + sd * rng.standard_normal(v.shape)).astype(np.float32),
                     "g": np.asarray(p["g"]),
                     "b": (b + eps * rng.standard_normal(b.shape)).astype(np.float32)}
    return out


def live_field_params(params, seed=0):
    """A field pytree with its SDF through live_sdf_params."""
    neuconw = dict(params["neuconw"], sdf=live_sdf_params(params["neuconw"]["sdf"], seed))
    return dict(params, neuconw=neuconw)


def torch_net(jax_params, cfg):
    net = SDFNetwork(cfg)
    sd = {}
    for name, p in jax_params.items():
        sd[f"{name}.weight_v"] = torch.from_numpy(np.asarray(p["v"]).T.copy())
        sd[f"{name}.weight_g"] = torch.from_numpy(np.asarray(p["g"])[:, None].copy())
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p["b"]).copy())
    net.load_state_dict(sd, strict=True)
    return net.requires_grad_(False)


@pytest.mark.parametrize("d_hidden,n_layers,skip,scale", [
    (64, 4, (2,), 1.0),
    (128, 4, (2,), 2.0),
    (512, 8, (4,), 1.0),  # the brandenburg_gate width
])
def test_sdf_head_matches_pallas_interpret(d_hidden, n_layers, skip, scale):
    cfg = sdf_cfg(d_hidden, n_layers, skip, scale)
    items = tuple(sorted(cfg.items()))
    params = live_sdf_params(init_sdf(jax.random.PRNGKey(d_hidden), cfg))
    pts = (np.random.default_rng(0).standard_normal((256, 3)) * 0.5).astype(np.float32)
    want = np.asarray(jax_fused_sdf_head(params, items, jnp.asarray(pts), tile=256,
                                         interpret=True))
    packed = pack_sdf_weights(torch_net(params, cfg), items, "float32")
    got = fused_sdf_head(packed, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_fused_field_sdf_matches_pallas_interpret():
    """Batched shapes round-trip through the drop-in for field_sdf."""
    from neuralrecon_w_tpu.config import get_cfg_defaults
    from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config
    from neuralrecon_w_tpu.models import init_field
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg
    from neuralrecon_w_tpu_torch.tools.convert import field_from_jax

    cfg = get_cfg_defaults()
    cfg.NEUCONW.N_VOCAB = 8
    cfg.NEUCONW.SDF_CONFIG.d_hidden = 128
    cfg.NEUCONW.SDF_CONFIG.d_out = 129
    jfc = jax_field_config(cfg)
    params = live_field_params(init_field(jax.random.PRNGKey(0), jfc))
    model = field_from_jax(jax.tree.map(np.asarray, params), field_config_from_cfg(cfg))
    pts = (np.random.default_rng(1).standard_normal((5, 7, 3)) * 0.4).astype(np.float32)
    want = np.asarray(jax_fused_field_sdf(params, jfc, jnp.asarray(pts), tile=64,
                                          interpret=True))
    with torch.no_grad():
        got = fused_field_sdf(model, field_config_from_cfg(cfg), torch.from_numpy(pts)).numpy()
    assert got.shape == (5, 7)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_pack_sdf_weights_layout():
    cfg = sdf_cfg(64, 4, (2,))
    items = tuple(sorted(cfg.items()))
    net = torch_net(init_sdf(jax.random.PRNGKey(0), cfg), cfg)
    for act, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        packed = pack_sdf_weights(net, items, act)
        assert packed.w.dtype == dt and packed.b.dtype == torch.float32
        # [39 PE] -> 64 -> 25 (shrunk before the skip) -> [25 | 39] -> 64 -> column 0
        assert packed.k == (39, 64, 64, 64, 64)
        assert packed.kpad == (48, 64, 64, 64, 64)
        assert packed.n == (64, 25, 64, 64, 1)
        assert packed.npad == (64, 32, 64, 64, 1)
        assert packed.skip_mask == 1 << 2
        w, b = packed.layer(1)
        assert w.shape == (25, 64) and b.shape == (25,)
        # padding is zero, so the kernels may read it
        full = packed.w[packed.woff[0]:packed.woff[1]].view(64, 48)
        assert float(full[:, 39:].abs().max()) == 0.0
    with pytest.raises(ValueError):
        pack_sdf_weights(torch_net(init_sdf(jax.random.PRNGKey(0), sdf_cfg(72, 4, (2,))),
                                   sdf_cfg(72, 4, (2,))),
                         tuple(sorted(sdf_cfg(72, 4, (2,)).items())), "bfloat16")


def test_kernel_wrapper_takes_no_other_path():
    """The wrapper runs the plain version only for CPU tensors; a tensor
    elsewhere reaches the kernel path (which checks its device) or raises,
    never the plain version."""
    cfg = sdf_cfg(64, 4, (2,))
    items = tuple(sorted(cfg.items()))
    packed = pack_sdf_weights(torch_net(init_sdf(jax.random.PRNGKey(0), cfg), cfg), items)
    with pytest.raises(ValueError):
        fused_sdf_head(packed, torch.empty(4, 3, device="meta"))
    with pytest.raises(ValueError):
        fused_sdf_head(packed, torch.zeros(4, 3, dtype=torch.float64))
