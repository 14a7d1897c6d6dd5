"""PyTorch port, kernel 6 (the fused NeRF++ background): the plain versions
of K8 (forward) and K9 + K5 (backward), which the kernels are held to on
the card, against the JAX package's Pallas kernels
(``ops/pallas_nerf_bg.py``) in interpret mode and ``jax.grad`` through
them, with and without the appearance head; and 'pallas' through
``field_background`` against 'xla'."""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralrecon_w_tpu.config import get_cfg_defaults  # noqa: E402
from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config  # noqa: E402
from neuralrecon_w_tpu.models import init_field as jax_init_field  # noqa: E402
from neuralrecon_w_tpu.ops.pallas_nerf_bg import nerf_bg_pallas  # noqa: E402
from neuralrecon_w_tpu_torch.config import field_config_from_cfg  # noqa: E402
from neuralrecon_w_tpu_torch.models.neuconw import field_background  # noqa: E402
from neuralrecon_w_tpu_torch.ops import nerf_bg_fused as bgf  # noqa: E402
from neuralrecon_w_tpu_torch.tools.convert import field_from_jax, params_from_jax  # noqa: E402

torch.set_num_threads(1)

F32_ATOL = 1e-5  # the forward, f32: summation order only
GRAD_REL = 1e-5  # every gradient against jax.grad, f32 (first order)
BF16_REL = 1e-2  # bf16, rel-L2 per output: both sides round at the same places
TILE = 32  # JAX interpret-mode tile: 24 points, one ragged grid step
N_A = 8


def make_case(encode_a, n=24, seed=0):
    cfg = get_cfg_defaults()
    cfg.NEUCONW.N_VOCAB, cfg.NEUCONW.N_A, cfg.NEUCONW.ENCODE_A_BG = 8, N_A, encode_a
    cfg.NEUCONW.SDF_CONFIG.d_hidden, cfg.NEUCONW.SDF_CONFIG.d_out = 64, 65
    cfg.NEUCONW.COLOR_CONFIG.d_feature = 64
    params = jax_init_field(jax.random.PRNGKey(seed), jax_field_config(cfg))
    fc = field_config_from_cfg(cfg)
    model = field_from_jax(jax.tree.map(np.asarray, params), fc, "cpu")
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((n, 3))
    pts4 = np.concatenate([xyz / np.linalg.norm(xyz, axis=-1, keepdims=True),
                           rng.uniform(0.05, 1.0, (n, 1))], -1).astype(np.float32)
    dirs = rng.standard_normal((n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    a = (rng.standard_normal((n, N_A)) * 0.3).astype(np.float32) if encode_a else None
    cots = (rng.standard_normal((n, 1)).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32))
    return params, model, fc, (pts4, dirs, a), cots


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def plain_args(model, encode_a, x):
    layers = bgf.bg_layers(model.nerf, encode_a)
    ws = [m.weight.detach() for m in layers]
    bs = [m.bias.detach() for m in layers]
    return ws, bs, [None if v is None else torch.from_numpy(v) for v in x]


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("encode_a", [True, False])
def test_plain_matches_pallas_interpret(encode_a, act):
    """bg_fwd_plain / bg_bwd_plain against bg_fwd_pallas and jax.grad
    through nerf_bg_pallas: density, rgb, every layer's dW / db, d_pts4,
    d_dirs and (with the appearance head) d_a."""
    params, model, _, x, cots = make_case(encode_a, seed=1 + encode_a)
    jx = [None if v is None else jnp.asarray(v) for v in x]

    def jloss(p, pts4, dirs, a):
        den, rgb = nerf_bg_pallas(p, encode_a, pts4, dirs, a, act_dtype=act, tile=TILE,
                                  interpret=True)
        return jnp.sum(den * cots[0]) + jnp.sum(rgb * cots[1]), (den, rgb)

    argnums = (0, 1, 2, 3) if encode_a else (0, 1, 2)
    jg, (w_den, w_rgb) = jax.grad(jloss, argnums=argnums, has_aux=True)(params["nerf_bg"], *jx)
    ws, bs, tx = plain_args(model, encode_a, x)
    den, rgb = bgf.bg_fwd_plain(ws, bs, *tx, act)
    dWs, dbs, d_p4, d_dirs, d_a = bgf.bg_bwd_plain(ws, bs, *tx, *map(torch.from_numpy, cots),
                                                   act)
    assert den.shape == (24, 1) and rgb.shape == (24, 3) and (d_a is None) == (not encode_a)
    want = params_from_jax({"embedding_a": np.zeros((1, 1)), "nerf_bg": jax.tree.map(
        np.asarray, jg[0]), "neuconw": {"sdf": {}, "color": {}, "variance": np.zeros(())}})
    names = [n for n, _ in model.nerf.named_parameters()]
    got = dict(zip([f"nerf.{n}" for n in names], _by_module(model.nerf, encode_a, dWs, dbs)))
    pairs = [(den, w_den), (rgb, w_rgb)]
    grads = [(got[k], want[k]) for k in got] + [(d_p4, jg[1]), (d_dirs, jg[2])]
    if encode_a:
        grads.append((d_a, jg[3]))
    for g, w in pairs + grads:
        assert tuple(g.shape) == tuple(np.shape(w))
    for g, w in pairs:
        if act == "float32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_ATOL, rtol=0)
        else:
            assert rel_l2(g.numpy(), w) <= BF16_REL
    for g, w in grads:
        assert rel_l2(g.numpy(), w) <= (GRAD_REL if act == "float32" else BF16_REL)


def _by_module(net, encode_a, dWs, dbs):
    """The per-layer (dW, db) in the order of net.named_parameters()."""
    order = {id(m): i for i, m in enumerate(bgf.bg_layers(net, encode_a))}
    out = []
    for _, m in net.named_modules():
        if id(m) in order:
            out += [dWs[order[id(m)]], dbs[order[id(m)]]]
    return out


@pytest.mark.parametrize("encode_a", [True, False])
def test_field_background_pallas_matches_xla(encode_a):
    """field_background in 'pallas' (per-sample dirs and a, the plain K8 /
    K9 on the CPU) against 'xla' (autograd, the appearance head's per-ray
    shortcut), f32, per-ray dirs and a through the embedding: outputs and
    every background parameter's, pts4's, dirs' and the table's gradient."""
    _, model, fc, (pts4, dirs, _), cots = make_case(encode_a, n=24, seed=3)
    ts = torch.arange(6) % 8

    def run(mode):
        m = copy.deepcopy(model).requires_grad_(True)
        p = torch.from_numpy(pts4).requires_grad_(True)
        d = torch.from_numpy(dirs[:6]).requires_grad_(True)
        den, rgb = field_background(m, fc._replace(bg_mode=mode), p, d, m.embedding_a(ts), 4)
        (torch.sum(den * torch.from_numpy(cots[0])) + torch.sum(rgb * torch.from_numpy(cots[1]))
         ).backward()
        g = {k: v.grad for k, v in m.named_parameters() if v.grad is not None}
        return (den.detach(), rgb.detach()), g | {"pts4": p.grad, "dirs": d.grad}

    (o_k, g_k), (o_x, g_x) = run("pallas"), run("xla")
    for k, v in zip(o_k, o_x):
        torch.testing.assert_close(k, v, atol=F32_ATOL, rtol=0)
    assert set(g_k) == set(g_x) and ("embedding_a.weight" in g_k) == encode_a
    for k in g_x:
        assert rel_l2(g_k[k].numpy(), g_x[k].numpy()) <= GRAD_REL, k


def test_pack_bg_weights_layout():
    """The 11 + H layers in bg_layer_names order, each W (npad, kpad) then W^T,
    zero beyond the layer; pts5 takes [pe | h] (84 + 256), app0 [feature |
    PE_view | a] (256 + 27 + 8)."""
    _, model, _, _, _ = make_case(True, n=4)
    layers = bgf.bg_layers(model.nerf, True)
    assert len(layers) == len(bgf.bg_layer_names(True)) == 15
    assert len(bgf.bg_layers(make_case(False, n=4)[1].nerf, False)) == 12
    pk = bgf.pack_bg_weights([m.weight for m in layers], [m.bias for m in layers], "bfloat16")
    assert pk.n_head == 4 and pk.w.dtype == torch.bfloat16 and pk.b.dtype == torch.float32
    assert pk.k[5] == 84 + 256 and pk.k[bgf.HEAD] == 256 + 27 + N_A and pk.n[bgf.ALPHA] == 1
    for i, m in enumerate(layers):
        npad, kpad = pk.npad[i], pk.kpad[i]
        w = pk.w[pk.w_off[i]:pk.w_off[i] + npad * kpad].view(npad, kpad)
        assert torch.equal(w[:pk.n[i], :pk.k[i]], m.weight.detach().to(torch.bfloat16))
        assert float(w[pk.n[i]:].float().abs().sum()) == 0.0
        assert float(w[:, pk.k[i]:].float().abs().sum()) == 0.0
        wt = pk.w[pk.wt_off[i]:pk.wt_off[i] + npad * kpad].view(kpad, npad)
        assert torch.equal(w.t(), wt)


def test_wrapper_takes_no_other_path():
    """CPU tensors take the plain versions and count no launch; a tensor
    elsewhere reaches the kernel path, which checks its device."""
    _, model, _, x, cots = make_case(True, n=8, seed=4)
    before = (bgf.nerf_bg_fwd.launches, bgf.nerf_bg_bwd.launches)
    xs = [torch.from_numpy(v).requires_grad_(True) for v in x]
    den, rgb = bgf.nerf_bg_kernel(model.nerf, True, *xs)
    (den.sum() + rgb.sum()).backward()
    assert (bgf.nerf_bg_fwd.launches, bgf.nerf_bg_bwd.launches) == before
    assert all(t.grad is not None for t in xs)
    with pytest.raises(ValueError):
        bgf.nerf_bg_kernel(model.nerf, True, *[torch.from_numpy(v).to("meta") for v in x])
