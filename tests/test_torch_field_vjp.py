"""PyTorch port, the SDF-VJP kernels' plain version (``ops/field_vjp_math.py``),
which K3 / K4 / K5 are held to on the card: against the JAX package's
``field_vjp_math`` and its Pallas custom VJP in interpret mode, the
autograd.Function against the torch double backward (float64 and float32),
and mutations that the comparisons must catch."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralrecon_w_tpu.models.sdf import _layer_weight, init_sdf  # noqa: E402
from neuralrecon_w_tpu.ops import field_vjp_math as jax_fvm  # noqa: E402
from neuralrecon_w_tpu.ops.pallas_field_vjp import sdf_value_feat_grad_pallas  # noqa: E402
from neuralrecon_w_tpu.models.sdf import sdf_value_feat_grad_fwdmode as jax_fwdmode  # noqa: E402
from neuralrecon_w_tpu_torch.models.sdf import sdf_value_feat_grad  # noqa: E402
from neuralrecon_w_tpu_torch.models.sdf import sdf_value_feat_grad_fwdmode  # noqa: E402
from neuralrecon_w_tpu_torch.ops import field_vjp_math as fvm  # noqa: E402
from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp  # noqa: E402
from test_torch_sdf_mlp import live_sdf_params, sdf_cfg, torch_net  # noqa: E402

torch.set_num_threads(1)

PRIMAL_ATOL = 1e-5
FWD_ATOL = 1e-5  # 'fwd' against JAX's 'fwd' and the port's 'vjp', f32
FWD_GRAD_REL_L2 = 1e-5  # one 'fwd' training step against JAX's, every parameter gradient
# (or twice the two packages' 'vjp' steps' own distance, where that is larger)
# the JAX suite's own bounds (tests/test_pallas_field_vjp.py:36-38, 66, 132)
GRAD_ATOL = {"shallow": 2e-4, "deep": 3e-4}
NETS = {"shallow": (128, 4, (2,), 1.3), "deep": (64, 8, (4,), 1.3)}
N_PTS = 24


def setup(name, seed=0):
    d, n_layers, skip, scale = NETS[name]
    cfg = sdf_cfg(d, n_layers, skip, scale)
    params = live_sdf_params(init_sdf(jax.random.PRNGKey(seed), cfg), seed)
    rs = np.random.RandomState(seed)
    x = (rs.randn(N_PTS, 3) * 0.5).astype(np.float32)
    c_out = rs.randn(N_PTS, d + 1).astype(np.float32)
    c_grad = rs.randn(N_PTS, 3).astype(np.float32)
    return cfg, params, x, c_out, c_grad


def jax_weights(params, n):
    ws = [np.asarray(_layer_weight({k: jnp.asarray(v) for k, v in params[f"lin{l}"].items()}))
          for l in range(n)]
    return ws, [np.asarray(params[f"lin{l}"]["b"]) for l in range(n)]


def port_vjp(cfg, params, x, c_out, c_grad):
    n = cfg["n_layers"] + 1
    ws, bs = jax_weights(params, n)
    tw = [torch.from_numpy(w.T.copy()) for w in ws]
    tb = [torch.from_numpy(b.copy()) for b in bs]
    args = (tuple(cfg["skip_in"]), cfg["multires"], float(cfg["scale"]))
    out, grad = fvm.value_and_grad(tw, tb, *args, torch.from_numpy(x))
    dWs, dbs, dx = fvm.vjp(tw, tb, *args, torch.from_numpy(x), torch.from_numpy(c_out),
                           torch.from_numpy(c_grad))
    return out, grad, [w.t().numpy() for w in dWs], [b.numpy() for b in dbs], dx.numpy()


def assert_vjp_close(got, want, atol):
    out, grad, dWs, dbs, dx = got
    w_out, w_grad, w_dWs, w_dbs, w_dx = want
    np.testing.assert_allclose(out, w_out, atol=PRIMAL_ATOL, rtol=0)
    np.testing.assert_allclose(grad, w_grad, atol=PRIMAL_ATOL, rtol=0)
    for a, b in zip(dWs + dbs, w_dWs + w_dbs):
        assert float(np.abs(a - b).max()) < atol * max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(dx, w_dx, atol=atol, rtol=0)


def jax_math(cfg, params, x, c_out, c_grad):
    ws, bs = jax_weights(params, cfg["n_layers"] + 1)
    args = ([jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs], tuple(cfg["skip_in"]),
            cfg["multires"], float(cfg["scale"]))
    res = jax_fvm.forward_with_residuals(*args, jnp.asarray(x))
    dWs, dbs, dx = jax_fvm.backward(*args, res, jnp.asarray(c_out), jnp.asarray(c_grad))
    return (np.asarray(res["out"]), np.asarray(res["grad"]), [np.asarray(w) for w in dWs],
            [np.asarray(b) for b in dbs], np.asarray(dx))


@pytest.mark.parametrize("name", ["shallow", "deep"])
def test_plain_matches_jax_field_vjp_math(name):
    cfg, params, x, c_out, c_grad = setup(name)
    assert_vjp_close(port_vjp(cfg, params, x, c_out, c_grad),
                     jax_math(cfg, params, x, c_out, c_grad), GRAD_ATOL[name])


@pytest.mark.parametrize("name", ["shallow", "deep"])
def test_plain_matches_pallas_interpret(name):
    """Against sdf_value_feat_grad_pallas in interpret mode: its primals and
    its gradient of sum(c_sdf sdf) + sum(c_feat feat) + sum(c_grad grad)
    in the effective weights and x."""
    cfg, params, x, c_out, c_grad = setup(name)
    n = cfg["n_layers"] + 1
    ws, bs = jax_weights(params, n)
    scale = float(cfg["scale"])

    def pallas(weights, biases, xx):
        p = {f"lin{l}": {"w": weights[l], "b": biases[l]} for l in range(n)}
        return sdf_value_feat_grad_pallas(p, dict(cfg, weight_norm=False), xx, tile=16,
                                          interpret=True)

    def loss(weights, biases, xx):
        s, f, g = pallas(weights, biases, xx)
        return (jnp.sum(s * c_out[:, 0] * scale) + jnp.sum(f * c_out[:, 1:])
                + jnp.sum(g * c_grad))

    args = ([jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs], jnp.asarray(x))
    s, f, g = pallas(*args)
    dWs, dbs, dx = jax.grad(loss, argnums=(0, 1, 2))(*args)
    want = (np.concatenate([np.asarray(s)[:, None] * scale, np.asarray(f)], 1), np.asarray(g),
            [np.asarray(w) for w in dWs], [np.asarray(b) for b in dbs], np.asarray(dx))
    assert_vjp_close(port_vjp(cfg, params, x, c_out, c_grad), want, GRAD_ATOL[name])


def function_grads(net, cfg, x, cots, kernel: bool):
    """Gradients of the seeded loss in weight_v, weight_g, bias and x, in
    x's dtype throughout."""
    net.zero_grad()
    xx = x.clone().requires_grad_(True)
    if kernel:
        s, f, g = vjp.sdf_value_feat_grad_kernel(net, tuple(sorted(cfg.items())), xx, x.dtype)
    else:
        s, f, g = sdf_value_feat_grad(net, cfg, xx, x.dtype, create_graph=True)
    c_sdf, c_feat, c_grad = cots
    (torch.sum(s * c_sdf) + torch.sum(f * c_feat) + torch.sum(g * c_grad)).backward()
    return [p.grad.clone() for p in net.parameters()] + [xx.grad.clone()]


@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-9), (torch.float32, None)])
@pytest.mark.parametrize("name", ["shallow", "deep"])
def test_function_matches_double_backward(name, dtype, rel):
    """The autograd.Function (its plain version on the CPU), through the
    weight norm to weight_v, weight_g and bias, and to x, against the torch
    double backward of the 'vjp' grad mode on the same loss. In float64 the
    two are the same math to rounding; in float32 within the JAX suite's
    bounds."""
    cfg, params, x, c_out, c_grad = setup(name, seed=1)
    net = torch_net(params, cfg).to(dtype).requires_grad_(True)
    xt = torch.from_numpy(x).to(dtype)
    cots = (torch.from_numpy(c_out[:, 0]).to(dtype), torch.from_numpy(c_out[:, 1:]).to(dtype),
            torch.from_numpy(c_grad).to(dtype))
    got = function_grads(net, cfg, xt, cots, kernel=True)
    want = function_grads(net, cfg, xt, cots, kernel=False)
    for a, b in zip(got, want):
        if rel is not None:
            assert float((a - b).norm()) <= rel * max(float(b.norm()), 1e-30)
        else:
            scale = max(float(b.abs().max()), 1.0)
            assert float((a - b).abs().max()) < GRAD_ATOL[name] * scale


def test_function_hybrid_and_primals():
    """fwd_impl 'plain' (the pallas_hybrid mode) gives the same values and
    gradients; sdf = out[:, 0] / scale and feat = out[:, 1:]."""
    cfg, params, x, c_out, c_grad = setup("shallow", seed=2)
    net = torch_net(params, cfg).requires_grad_(True)
    xt = torch.from_numpy(x)
    s, f, g = vjp.sdf_value_feat_grad_kernel(net, tuple(sorted(cfg.items())), xt, "float32",
                                             fwd_impl="plain")
    s2, f2, g2 = sdf_value_feat_grad(net, cfg, xt, torch.float32)
    for a, b in ((s, s2), (f, f2), (g, g2)):
        torch.testing.assert_close(a, b, atol=PRIMAL_ATOL, rtol=0)
    with pytest.raises(ValueError):
        vjp.sdf_value_feat_grad_kernel(net, tuple(sorted(cfg.items())), xt, fwd_impl="xla")


def test_bfloat16_rounds_products_only():
    """act bfloat16: every product's operands are bf16 values, sums f32;
    the result moves from the f32 one by bf16 rounding, not more."""
    cfg, params, x, c_out, c_grad = setup("shallow")
    n = cfg["n_layers"] + 1
    ws, bs = jax_weights(params, n)
    tw = [torch.from_numpy(w.T.copy()) for w in ws]
    tb = [torch.from_numpy(b.copy()) for b in bs]
    args = (tuple(cfg["skip_in"]), cfg["multires"], float(cfg["scale"]), torch.from_numpy(x))
    res = fvm.forward_with_residuals(tw, tb, *args, torch.bfloat16)
    assert all(torch.equal(u, u.to(torch.bfloat16).float()) for u in res["us"][:1])
    out32, grad32 = fvm.value_and_grad(tw, tb, *args)
    rel = float((res["out"] - out32).norm() / out32.norm())
    assert 1e-4 < rel < 5e-2


@pytest.mark.parametrize("mutation", ["z2", "pe_jac_x", "skip_scale"])
def test_mutations_are_caught(mutation, monkeypatch):
    """The comparison with JAX fails if the plain version drops the z2
    (sp'') injection, drops the x-dependence of the PE Jacobian, or leaves
    out the 1/sqrt 2 of the skip split."""
    if mutation == "z2":
        monkeypatch.setattr(fvm, "_sp2", lambda z: torch.zeros_like(z))
    elif mutation == "pe_jac_x":
        monkeypatch.setattr(fvm, "_pe_jac_x_cot", lambda xs, m, g, c: torch.zeros_like(xs))
    else:
        monkeypatch.setattr(fvm, "_skip_split", lambda r, d_h: (r[:, :d_h], r[:, d_h:]))
    cfg, params, x, c_out, c_grad = setup("shallow")
    with pytest.raises(AssertionError):
        assert_vjp_close(port_vjp(cfg, params, x, c_out, c_grad),
                         jax_math(cfg, params, x, c_out, c_grad), GRAD_ATOL["shallow"])


def test_wrappers_take_no_other_path():
    """On the CPU the wrappers run the plain version; any other device goes
    to the kernel path, which checks its tensors and raises here."""
    cfg, params, x, c_out, c_grad = setup("shallow")
    n = cfg["n_layers"] + 1
    ws, bs = jax_weights(params, n)
    tw = [torch.from_numpy(w.T.copy()) for w in ws]
    tb = [torch.from_numpy(b.copy()) for b in bs]
    out, grad = vjp.sdf_vjp_fwd(tw, tb, cfg, torch.from_numpy(x))
    assert out.shape == (N_PTS, 129) and grad.shape == (N_PTS, 3)
    with pytest.raises(ValueError):
        vjp.sdf_vjp_fwd(tw, tb, cfg, torch.empty(4, 3, device="meta"))
    with pytest.raises(ValueError):
        vjp.sdf_vjp_bwd(tw, tb, cfg, torch.empty(4, 3, device="meta"),
                        torch.empty(4, 129, device="meta"), torch.empty(4, 3, device="meta"))


def test_pack_layout():
    """Each layer's W (npad, kpad) and W^T (kpad, npad), zero-padded to 16."""
    cfg = sdf_cfg(64, 4, (2,))
    net = torch_net(init_sdf(jax.random.PRNGKey(0), cfg), cfg)
    ws = [net.layer(l).effective_weight() for l in range(net.n_layers)]
    pk = vjp.pack_vjp_weights(ws, [net.layer(l).bias for l in range(net.n_layers)], cfg,
                              "bfloat16")
    assert pk.w.dtype == torch.bfloat16 and pk.b.dtype == torch.float32
    assert pk.k == (39, 64, 64, 64, 64) and pk.n == (64, 25, 64, 64, 65)
    assert pk.kpad == (48, 64, 64, 64, 64) and pk.npad == (64, 32, 64, 64, 80)
    assert pk.skip_mask == 1 << 2
    for l in range(net.n_layers):
        npad, kpad = pk.npad[l], pk.kpad[l]
        w = pk.w[pk.w_off[l]:pk.w_off[l] + npad * kpad].view(npad, kpad).float()
        wt = pk.w[pk.wt_off[l]:pk.wt_off[l] + npad * kpad].view(kpad, npad).float()
        assert torch.equal(w, wt.t())
        torch.testing.assert_close(w[:pk.n[l], :pk.k[l]], ws[l].detach().to(torch.bfloat16).float())
        assert float(w[pk.n[l]:].abs().sum() + w[:, pk.k[l]:].abs().sum()) == 0.0


@pytest.mark.parametrize("mode", ["fwd", "pallas_field"])
def test_unported_grad_modes_raise(mode):
    """Neither mode raises any more: 'pallas_field' since kernel 5's port (on
    the CPU through the plain versions), 'fwd' since the forward-mode port;
    each gives per-sample rgb, sdf and grad, and 'fwd''s equal 'vjp''s on
    the same field (f32, 1e-5)."""
    from neuralrecon_w_tpu.config import get_cfg_defaults
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg
    from neuralrecon_w_tpu_torch.models.neuconw import field_forward
    from neuralrecon_w_tpu_torch.tools.convert import init_field

    cfg = get_cfg_defaults()
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
    n.SDF_CONFIG.skip_in = (2,)
    n.COLOR_CONFIG.d_feature, n.N_VOCAB = 64, 4
    cfg.TPU.SDF_GRAD_MODE = mode
    fc = field_config_from_cfg(cfg)
    model = init_field(fc, torch.Generator().manual_seed(0), "cpu")
    pts = torch.from_numpy(np.random.RandomState(0).randn(4, 3).astype(np.float32) * 0.5)
    args = (model, fc, pts, torch.zeros(4, 3), torch.zeros(4, 48))
    rgb, _, sdf, grad = field_forward(*args)
    assert rgb.shape == (4, 3) and sdf.shape == (4,) and grad.shape == (4, 3)
    assert all(bool(torch.isfinite(t).all()) for t in (rgb, sdf, grad))
    if mode == "fwd":
        want = field_forward(model, fc._replace(grad_mode="vjp"), *args[2:])
        for g, w in zip((rgb, sdf, grad), (want[0], want[2], want[3])):
            torch.testing.assert_close(g, w, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["shallow", "deep"])
def test_fwdmode_matches_jax_and_vjp(name):
    """sdf_value_feat_grad_fwdmode (one primal and three tangent passes)
    against JAX's (jax.linearize) and the port's 'vjp': sdf, feature and
    gradient in f32 within 1e-5; under no_grad none carries a graph, under
    autograd all three do."""
    cfg, params, x, _, _ = setup(name)
    want = [np.asarray(t) for t in jax_fwdmode(params, cfg, jnp.asarray(x))]
    net = torch_net(params, cfg).requires_grad_(True)
    got = sdf_value_feat_grad_fwdmode(net, cfg, torch.from_numpy(x))
    vjp_ = sdf_value_feat_grad(net, cfg, torch.from_numpy(x))
    assert all(t.requires_grad for t in got)
    for g, v, w in zip(got, vjp_, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), w, atol=FWD_ATOL, rtol=0)
        np.testing.assert_allclose(g.detach().numpy(), v.numpy(), atol=FWD_ATOL, rtol=0)
    with torch.no_grad():
        served = sdf_value_feat_grad_fwdmode(net, cfg, torch.from_numpy(x))
    assert not any(t.requires_grad for t in served)


def test_fwd_train_step_matches_jax():
    """One steady-phase training step in 'fwd' (reverse over forward)
    against JAX's 'fwd' step from the same weights and batch (f32): every
    loss term within 1e-5, and every parameter gradient within rel-L2
    max(1e-5, 2 x the same parameter's error between the two packages'
    'vjp' steps). The two packages sum the step's f32 gradients in other
    orders, which leaves the 'vjp' steps ~1.6e-5 apart on some parameters
    (the background's among them, which 'fwd' does not touch)."""
    from test_torch_train_step import (grid_host, jax_step, make_batch, port_step, rel_l2,
                                       setup_cfg)
    from test_torch_sdf_mlp import live_field_params
    from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config
    from neuralrecon_w_tpu.models import init_field as jax_init_field

    batch, fine = make_batch(), grid_host()
    out = {}
    for mode in ("fwd", "vjp"):
        cfg = setup_cfg()
        cfg.TPU.SDF_GRAD_MODE = mode
        params = live_field_params(jax_init_field(jax.random.PRNGKey(0), jax_field_config(cfg)))
        out[mode] = (jax_step(cfg, params, batch, fine), port_step(cfg, params, batch, fine, mode))
    (want_aux, want_g), (got_aux, got_g) = out["fwd"]
    (_, vjp_want), (_, vjp_got) = out["vjp"]
    assert set(want_aux) == set(got_aux)
    for k, v in want_aux.items():
        assert got_aux[k] == pytest.approx(v, rel=FWD_ATOL, abs=1e-7), k
    assert set(got_g) == set(want_g)
    errs = {k: rel_l2(got_g[k].numpy(), want_g[k].numpy()) for k in want_g}
    floor = {k: 2 * rel_l2(vjp_got[k].numpy(), vjp_want[k].numpy()) for k in want_g}
    bad = {k: (e, floor[k]) for k, e in errs.items() if e > max(FWD_GRAD_REL_L2, floor[k])}
    assert not bad, bad
    assert all(float(got_g[k].abs().max()) > 0 for k in got_g if k.startswith("neuconw.sdf_net."))


def test_fwd_runs_sdf_in_float32_under_bf16():
    """With FIELD_DTYPE bfloat16 'fwd' still evaluates the SDF net in f32
    (as JAX's apply_sdf default): sdf, feature and gradient are f32 and
    equal the f32 field's; the colour head runs in bf16 (its rgb within bf16
    rounding of the f32 field's, not equal)."""
    from neuralrecon_w_tpu.config import get_cfg_defaults
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg
    from neuralrecon_w_tpu_torch.models.neuconw import field_forward
    from neuralrecon_w_tpu_torch.tools.convert import init_field

    cfg = get_cfg_defaults()
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
    n.SDF_CONFIG.skip_in = (2,)
    n.COLOR_CONFIG.d_feature, n.N_VOCAB = 64, 4
    cfg.TPU.SDF_GRAD_MODE = "fwd"
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg.TPU.FIELD_DTYPE = dt
        fc = field_config_from_cfg(cfg)
        assert fc.act_dtype == dt
        model = init_field(fc, torch.Generator().manual_seed(0), "cpu")
        pts = torch.from_numpy(np.random.RandomState(1).randn(16, 3).astype(np.float32) * 0.5)
        sdf, feat, grad = sdf_value_feat_grad_fwdmode(model.neuconw.sdf_net, fc.sdf_cfg, pts)
        rgb = field_forward(model, fc, pts, torch.zeros(16, 3), torch.zeros(16, 48))[0]
        out[dt] = (sdf, feat, grad, rgb)
    for a, b in zip(out["float32"][:3], out["bfloat16"][:3]):
        assert b.dtype == torch.float32
        assert torch.equal(a, b)
    rgb32, rgb16 = out["float32"][3].float(), out["bfloat16"][3].float()
    assert not torch.equal(rgb32, rgb16)
    torch.testing.assert_close(rgb16, rgb32, atol=2e-2, rtol=0)
