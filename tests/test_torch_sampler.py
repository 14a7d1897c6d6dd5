"""PyTorch port, the importance sampler (K2 and K1's plain versions, which
the kernels are held to on the card) against the JAX Pallas sampler in
interpret mode and against the jnp importance stage of sparse_sampler."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralrecon_w_tpu.models import field_sdf as jax_field_sdf  # noqa: E402
from neuralrecon_w_tpu.models.sdf import init_sdf  # noqa: E402
from neuralrecon_w_tpu.ops.pallas_sampler import (  # noqa: E402
    fused_importance_sampler as jax_fused_importance_sampler,
)
from neuralrecon_w_tpu.rendering import sampling as jax_sampling  # noqa: E402
from neuralrecon_w_tpu_torch.models.sdf import SDFNetwork  # noqa: E402
from neuralrecon_w_tpu_torch.ops.importance_sampler import (  # noqa: E402
    fused_importance_sampler,
    importance_sampler_plain,
    up_sample_round,
)
from neuralrecon_w_tpu_torch.rendering import sampling  # noqa: E402
from test_torch_sdf_mlp import live_sdf_params  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-4  # the JAX sampler test's own bound (tests/test_pallas_sampler.py)
# bf16 activations: XLA and torch round the same bf16 MLP at other points
# (sdf values differ by ~1e-3), which moves a drawn sample within its bin
BF16_ATOL = 2e-2


def setup(d_hidden=64, n_layers=4, skip=(2,), seed=0, r=16, n0=8):
    cfg = dict(d_in=3, d_out=d_hidden + 1, d_hidden=d_hidden, n_layers=n_layers,
               skip_in=skip, multires=6, bias=0.5, scale=1, geometric_init=True,
               weight_norm=True, inside_outside=False)
    items = tuple(sorted(cfg.items()))
    params = live_sdf_params(init_sdf(jax.random.PRNGKey(seed), cfg), seed)
    net = SDFNetwork(cfg)
    sd = {}
    for name, p in params.items():
        sd[f"{name}.weight_v"] = torch.from_numpy(np.asarray(p["v"]).T.copy())
        sd[f"{name}.weight_g"] = torch.from_numpy(np.asarray(p["g"])[:, None].copy())
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p["b"]).copy())
    net.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((r, 3)) * 0.1 + [0, 0, 0.9]).astype(np.float32)
    d = -o + rng.standard_normal((r, 3)).astype(np.float32) * 0.05
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    z = np.sort(rng.random((r, n0)).astype(np.float32) * 1.5 + 0.05, axis=-1)
    return params, items, net.requires_grad_(False), o, d, z


@pytest.mark.parametrize("act,atol", [("float32", ATOL), ("bfloat16", BF16_ATOL)])
def test_sampler_matches_pallas_interpret(act, atol):
    """2 rounds at s_val_base 3 (inv_s 512 then 1024), as served."""
    params, items, net, o, d, z = setup()
    want = np.asarray(jax_fused_importance_sampler(
        params, items, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z), 16, 2, 3,
        tile=16, interpret=True, act_dtype=act, layout="rows"))
    got = fused_importance_sampler(net, items, torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(z), 16, 2, 3, act_dtype=act).numpy()
    assert got.shape == (16, 24)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    assert np.all(np.diff(got, axis=-1) >= 0)


@pytest.mark.parametrize("steps,s_base", [(2, 3), (1, 0), (4, 0)])
def test_sampler_matches_jnp_importance_stage(steps, s_base):
    """The port's kernel-path stage and its plain stage against
    sparse_sampler's unfused stage: field_sdf + up_sample + cat_z_vals
    (rendering/renderer.py:294-306)."""
    params, items, net, o, d, z = setup(seed=1)

    class FC:
        sdf = items
        sdf_cfg = dict(items)
        act_dtype = "float32"

    jparams = {"neuconw": {"sdf": params}}

    def stage(o, d, z_vals):
        sdf_fn = lambda pts: jax_field_sdf(jparams, FC, pts)  # noqa: E731
        sdf = sdf_fn(o[:, None, :] + d[:, None, :] * z_vals[..., None])
        for i in range(steps):
            new_z = jax_sampling.up_sample(o, d, z_vals, sdf, 16 // steps,
                                           64.0 * 2 ** (s_base + i))
            z_vals, sdf = jax_sampling.cat_z_vals(sdf_fn, o, d, z_vals, new_z, sdf,
                                                  last=(i + 1 == steps))
        return z_vals

    want = np.asarray(jax.jit(stage)(jnp.asarray(o), jnp.asarray(d), jnp.asarray(z)))
    for sampler in (fused_importance_sampler, importance_sampler_plain):
        got = sampler(net, items, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(z), 16, steps, s_base).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=sampler.__name__)


def test_up_sample_round_contract():
    """A middle round returns the merged (z, sdf) and the draws; the last
    returns the merge of everything, sorted."""
    rng = np.random.default_rng(2)
    r = 6
    o = torch.from_numpy(np.tile([[0.0, 0.0, -0.9]], (r, 1)).astype(np.float32))
    d = torch.from_numpy(np.tile([[0.0, 0.0, 1.0]], (r, 1)).astype(np.float32))
    za = torch.from_numpy(np.sort(rng.random((r, 8)), -1).astype(np.float32) * 1.8)
    zb = torch.from_numpy(np.sort(rng.random((r, 4)), -1).astype(np.float32) * 1.8)
    sa, sb = 0.45 - za, 0.45 - zb  # a plane crossing at z = 0.45
    z, s, new = up_sample_round(o, d, za, sa, zb, sb, 8, 512.0, last=False)
    assert z.shape == (r, 12) and s.shape == (r, 12) and new.shape == (r, 8)
    np.testing.assert_allclose(s.numpy(), 0.45 - z.numpy(), atol=1e-6)
    assert torch.all(torch.diff(z, dim=1) >= 0)
    out = up_sample_round(o, d, za, sa, zb, sb, 8, 512.0, last=True)
    np.testing.assert_array_equal(out.numpy(), sampling.merge_sorted(z, new).numpy())
    # the draws crowd the zero crossing
    assert float((new - 0.45).abs().median()) < 0.1


def test_merge_sorted_ties_and_payload_match_jax():
    a = np.array([[0.1, 0.2, 0.2, 0.7], [0.0, 0.5, 0.5, 0.5]], np.float32)
    b = np.array([[0.2, 0.3], [0.5, 0.9]], np.float32)
    pa = np.arange(8, dtype=np.float32).reshape(2, 4)
    pb = 100 + np.arange(4, dtype=np.float32).reshape(2, 2)
    want = jax_sampling.merge_sorted(*(jnp.asarray(x) for x in (a, b, pa, pb)))
    got = sampling.merge_sorted(*(torch.from_numpy(x) for x in (a, b, pa, pb)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a before b on ties: the payload of equal keys keeps a's first
    assert got[1][1].tolist() == [4.0, 5.0, 6.0, 7.0, 102.0, 103.0]


def test_sample_pdf_matches_jax():
    rng = np.random.default_rng(3)
    bins = np.sort(rng.random((12, 17)), -1).astype(np.float32)
    weights = rng.random((12, 16)).astype(np.float32)
    weights[:4, :] = 0.0  # flat rows take the denom < 1e-5 rule
    weights[4:8, 3] = 50.0  # peaked rows
    want = np.asarray(jax_sampling.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 9))
    got = sampling.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 9).numpy()
    # f32 cumsum / sum order differs between the frameworks
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
