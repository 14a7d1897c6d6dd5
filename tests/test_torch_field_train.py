"""PyTorch port, kernel 5 (the fused field in training): the plain versions
of its forward (K6's, ``field_forward_plain``) and of its backward (K7 +
K5's, ``field_train_bwd_plain``), which the kernels are held to on the
card, against the JAX package's Pallas kernels
(``ops/pallas_field_train.py``) in interpret mode and ``jax.grad`` through
them, on the same weights (carried over by params_from_jax) and inputs;
and 'pallas_field' through ``field_forward`` against the 'vjp' mode."""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralrecon_w_tpu.config import get_cfg_defaults  # noqa: E402
from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config  # noqa: E402
from neuralrecon_w_tpu.models import init_field as jax_init_field  # noqa: E402
from neuralrecon_w_tpu.ops.pallas_field_train import field_rgb_sdf_grad_pallas  # noqa: E402
from neuralrecon_w_tpu_torch.config import field_config_from_cfg  # noqa: E402
from neuralrecon_w_tpu_torch.models.neuconw import field_forward  # noqa: E402
from neuralrecon_w_tpu_torch.ops import field_forward as ff  # noqa: E402
from neuralrecon_w_tpu_torch.ops import field_train as ft  # noqa: E402
from neuralrecon_w_tpu_torch.tools.convert import field_from_jax, params_from_jax  # noqa: E402
from test_torch_sdf_mlp import live_field_params  # noqa: E402

torch.set_num_threads(1)

F32_ATOL = 1e-5  # the forward, f32: summation order only
BF16_REL = 1e-2  # the forward, bf16: rel-L2 per output (the JAX kernel keeps z in bf16)
GRAD_REL = 5e-3  # every gradient against jax.grad, f32
F64_REL = 1e-4  # the plain f32 backward against itself in float64
TILE = 32  # JAX interpret-mode tile: 48 points give two grid steps, one ragged


def small_cfg(act="float32"):
    """tests/test_torch_train_step.py's width: SDF 4 x 64 with skip (2,),
    colour 2 x 32 with the 128-wide appearance head, 8 appearance codes of
    8."""
    cfg = get_cfg_defaults()
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
    n.SDF_CONFIG.skip_in = (2,)
    n.COLOR_CONFIG.d_feature, n.COLOR_CONFIG.d_hidden, n.COLOR_CONFIG.n_layers = 64, 32, 2
    n.N_VOCAB, n.N_A = 8, 8
    cfg.TPU.FIELD_DTYPE = act
    return cfg


def make_case(act="float32", n=48, seed=0):
    cfg = small_cfg(act)
    params = live_field_params(jax_init_field(jax.random.PRNGKey(seed), jax_field_config(cfg)),
                               seed)
    fc = field_config_from_cfg(cfg)
    model = field_from_jax(jax.tree.map(np.asarray, params), fc, "cpu")
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n, 3)) * 0.4).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    a = np.asarray(params["embedding_a"])[rng.integers(0, 8, n)]
    cots = (rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32))
    return cfg, params, model, fc, (pts, dirs, a), cots


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_field(cfg, params, x):
    return field_rgb_sdf_grad_pallas(params, jax_field_config(cfg), *map(jnp.asarray, x),
                                     tile=TILE, interpret=True)


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_forward_plain_matches_pallas_interpret(act):
    """K6's plain version is kernel 5's forward: field_fwd_pallas computes
    the same (rgb, sdf, grad)."""
    cfg, params, model, fc, x, _ = make_case(act, seed=1)
    want = [np.asarray(w) for w in jax_field(cfg, params, x)]
    with torch.no_grad():
        got = ff.field_forward_plain(ff.pack_field(model, fc), *map(torch.from_numpy, x))
    for name, g, w in zip(("rgb", "sdf", "grad"), got, want):
        assert g.shape == w.shape, name
        if act == "float32":
            np.testing.assert_allclose(g.numpy(), w, atol=F32_ATOL, rtol=0, err_msg=name)
        else:
            assert rel_l2(g.numpy(), w) <= BF16_REL, name


def test_backward_plain_matches_jax_grad():
    """_FieldTrain on the CPU (the plain forward and backward) against
    jax.grad through the Pallas custom VJP in interpret mode: every SDF and
    colour parameter (the weight norm's v and g included), pts, dirs, a."""
    cfg, params, model, fc, x, cots = make_case(seed=2)

    def jloss(p, pts, dirs, a):
        rgb, sdf, grad = field_rgb_sdf_grad_pallas(p, jax_field_config(cfg), pts, dirs, a,
                                                   tile=TILE, interpret=True)
        return (jnp.sum(rgb * cots[0]) + jnp.sum(sdf * cots[1]) + jnp.sum(grad * cots[2]))

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(params, *map(jnp.asarray, x))
    want = params_from_jax(jax.tree.map(np.asarray, jg[0]))
    model.requires_grad_(True)
    xs = [torch.from_numpy(v).requires_grad_(True) for v in x]
    rgb, sdf, grad = ft.field_rgb_sdf_grad_kernel(model, fc, *xs)
    c = [torch.from_numpy(v) for v in cots]
    (torch.sum(rgb * c[0]) + torch.sum(sdf * c[1]) + torch.sum(grad * c[2])).backward()
    names = [k for k, _ in model.named_parameters() if "sdf_net." in k or "color_net." in k]
    assert len(names) == 5 * 3 + 3 * 3 + 2 + 2 * 2  # SDF, lin (v, g, b); xyz_final, static
    got = dict(model.named_parameters())
    for k in names:
        assert rel_l2(got[k].grad.numpy(), want[k].numpy()) <= GRAD_REL, k
    for name, xx, w in zip(("pts", "dirs", "a"), xs, jg[1:]):
        assert rel_l2(xx.grad.numpy(), np.asarray(w)) <= GRAD_REL, name


def test_backward_plain_f32_against_f64():
    """The plain f32 backward lies within 1e-4 of itself in float64 per
    output; the kernels on the card are held to the float64 one."""
    _, _, model, fc, x, cots = make_case(seed=3)
    spec = ft.field_spec(model, fc)
    with torch.no_grad():
        wb = [t.detach() for t in ft.field_weights(model)]
    args = [torch.from_numpy(v) for v in x + cots]
    got = ft.field_train_bwd_plain(spec, wb, *args)
    truth = ft.field_train_bwd_plain(spec, [w.double() for w in wb], *[t.double() for t in args])
    flat = lambda r: [*r[0], *r[1], *r[2], *r[3], *r[4:]]  # noqa: E731
    assert len(flat(got)) == len(wb) + 3
    for g, t in zip(flat(got), flat(truth)):
        assert g.dtype == torch.float32 and g.shape == t.shape
        assert rel_l2(g.numpy(), t.numpy()) <= F64_REL


def test_backward_plain_takes_masks():
    """field_train_bwd_plain with the colour ReLUs' own signs as masks gives
    what it gives without them; a mask flipped at one point moves the dWs
    and that point's dx, d_dirs and d_a, no other point's. On the card the
    kernel's masks stand in for the reference's own."""
    _, _, model, fc, x, cots = make_case(seed=7)
    spec = ft.field_spec(model, fc)
    with torch.no_grad():
        wb = [t.detach() for t in ft.field_weights(model)]
    args = [torch.from_numpy(v) for v in x + cots]
    zs = ft.color_preacts(spec, wb, *args[:3])
    assert [z.shape[1] for z in zs] == [128, 128, 32, 32]  # static 0..1, lin0..1
    masks = [z > 0 for z in zs]
    flat = lambda r: [*r[0], *r[1], *r[2], *r[3], *r[4:]]  # noqa: E731
    own = flat(ft.field_train_bwd_plain(spec, wb, *args))
    given = flat(ft.field_train_bwd_plain(spec, wb, *args, masks=masks))
    assert all(torch.equal(a, b) for a, b in zip(own, given))
    j = int(zs[-1][0].abs().argmax())  # a unit of lin1 far from 0 at point 0
    masks[-1][0, j] = ~masks[-1][0, j]
    flipped = flat(ft.field_train_bwd_plain(spec, wb, *args, masks=masks))
    assert not torch.equal(own[len(wb) - 2], flipped[len(wb) - 2])  # lin1.b
    for a, b in zip(own[len(wb):], flipped[len(wb):]):  # dx, d_dirs, d_a: point 0 alone
        assert not torch.equal(a[0], b[0]) and torch.equal(a[1:], b[1:])


@pytest.mark.parametrize("n_samples", [None, 8])
def test_field_forward_pallas_field_matches_vjp(n_samples):
    """field_forward in 'pallas_field' (the colour head per sample, dirs and
    a broadcast per sample when given per ray) against 'vjp' (the colour
    head's ray-constant part per ray), f32: outputs, and gradients of every
    parameter, pts, dirs and a; the appearance table through the embedding."""
    _, _, model, fc, (pts, dirs, a), cots = make_case(seed=4)
    ts = torch.arange(48 if n_samples is None else 6) % 8

    def run(mode):
        m = copy.deepcopy(model).requires_grad_(True)
        p = torch.from_numpy(pts).requires_grad_(True)
        d = torch.from_numpy(dirs if n_samples is None else dirs[:6]).requires_grad_(True)
        outs = field_forward(m, fc._replace(grad_mode=mode), p, d, m.embedding_a(ts), n_samples,
                             create_graph=True)
        rgb, _, sdf, grad, _ = outs
        c = [torch.from_numpy(v) for v in cots]
        (torch.sum(rgb * c[0]) + torch.sum(sdf * c[1]) + torch.sum(grad * c[2])).backward()
        g = {k: v.grad for k, v in m.named_parameters() if v.grad is not None}
        return [o.detach() for o in (rgb, sdf, grad)], g | {"pts": p.grad, "dirs": d.grad}

    (o_k, g_k), (o_v, g_v) = run("pallas_field"), run("vjp")
    for k, v in zip(o_k, o_v):
        torch.testing.assert_close(k, v, atol=F32_ATOL, rtol=0)
    assert set(g_k) == set(g_v) and "embedding_a.weight" in g_k
    for k in g_v:
        assert rel_l2(g_k[k].numpy(), g_v[k].numpy()) <= 1e-5, k


def test_wrapper_takes_no_other_path():
    """CPU tensors take the plain versions and count no launch; a tensor
    elsewhere reaches the kernel path, which checks its device, and never
    the plain version."""
    _, _, model, fc, x, cots = make_case(n=16, seed=5)
    before = (ff.fused_field_forward.launches, ft.field_train_bwd.launches)
    xs = [torch.from_numpy(v).requires_grad_(True) for v in x]
    rgb, sdf, grad = ft.field_rgb_sdf_grad_kernel(model, fc, *xs)
    (rgb.sum() + sdf.sum() + grad.sum()).backward()
    assert (ff.fused_field_forward.launches, ft.field_train_bwd.launches) == before
    with pytest.raises(ValueError):
        ft.field_rgb_sdf_grad_kernel(model, fc, *[torch.from_numpy(v).to("meta") for v in x])
    spec = ft.field_spec(model, fc)
    pack = ft.pack_field_tensors(spec, [t.detach() for t in ft.field_weights(model)])
    with pytest.raises(ValueError):
        ft.field_train_bwd(pack, *[torch.from_numpy(v).to("meta") for v in x + cots])


def test_color_pack_holds_w_and_w_transposed():
    """Per colour layer the packed W (npad, kpad) and W^T (kpad, npad), zero
    beyond the layer; the static head's first layer 64 + 27 + 8 wide."""
    _, _, model, fc, _, _ = make_case(n=4, seed=6)
    cp = ff.pack_color_weights(model.neuconw.color_net, fc.color, "float32")
    assert cp.k == (64, 64 + 27 + 8, 128, 134, 32, 32) and cp.n == (64, 128, 128, 32, 32, 3)
    for i in range(len(cp.k)):
        npad, kpad = cp.npad[i], cp.kpad[i]
        w = cp.w[cp.w_off[i]:cp.w_off[i] + npad * kpad].view(npad, kpad)
        wt = cp.w[cp.wt_off[i]:cp.wt_off[i] + npad * kpad].view(kpad, npad)
        assert torch.equal(w.t(), wt) and cp.wt_off[i] % 8 == 0
        assert float(w[cp.n[i]:].abs().sum()) == 0.0 and float(w[:, cp.k[i]:].abs().sum()) == 0.0
