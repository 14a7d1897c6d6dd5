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
    zero beyond the layer; pts5 takes [pe | h] (84 + 256) with the PE
    padded by zero columns to PE_PAD in the pack (kpad PE_PAD + 256), app0
    [feature | PE_view | a] (256 + 27 + 8)."""
    _, model, _, _, _ = make_case(True, n=4)
    layers = bgf.bg_layers(model.nerf, True)
    assert len(layers) == len(bgf.bg_layer_names(True)) == 15
    assert len(bgf.bg_layers(make_case(False, n=4)[1].nerf, False)) == 12
    pk = bgf.pack_bg_weights([m.weight for m in layers], [m.bias for m in layers], "bfloat16")
    assert pk.n_head == 4 and pk.w.dtype == torch.bfloat16 and pk.b.dtype == torch.float32
    assert pk.k[5] == 84 + 256 and pk.k[bgf.HEAD] == 256 + 27 + N_A and pk.n[bgf.ALPHA] == 1
    assert pk.kpad[5] == bgf.PE_PAD + 256 and bgf.D_PE == 84
    for i, m in enumerate(layers):
        npad, kpad = pk.npad[i], pk.kpad[i]
        w = pk.w[pk.w_off[i]:pk.w_off[i] + npad * kpad].view(npad, kpad)
        want = m.weight.detach().to(torch.bfloat16)
        if i == bgf.SKIP + 1:
            want = torch.cat([want[:, :bgf.D_PE], want.new_zeros(want.shape[0], bgf.PE_PAD - bgf.D_PE),
                              want[:, bgf.D_PE:]], dim=1)
        assert torch.equal(w[:pk.n[i], :want.shape[1]], want)
        assert float(w[pk.n[i]:].float().abs().sum()) == 0.0
        assert float(w[:, want.shape[1]:].float().abs().sum()) == 0.0
        wt = pk.w[pk.wt_off[i]:pk.wt_off[i] + npad * kpad].view(kpad, npad)
        assert torch.equal(w.t(), wt)


def kernel_layout_pass(pk, pts4, dirs, a, c_den, c_rgb):
    """K8's outputs and K9's input cotangents computed as the kernels walk
    the pack, in f32: every product a slice of the flat pk.w (W at w_off,
    W^T at wt_off), the operand as wide as the product's kpad (pts5's
    [pe | 0 | h] over PE_PAD + W columns, the head's [feature | PE_view |
    a | 0]), each transpose past 256 rows in its two row ranges (the PE or
    view part, then the rest), alpha's cotangent a rank-1 term."""
    def W(i):
        return pk.w[pk.w_off[i]:pk.w_off[i] + pk.npad[i] * pk.kpad[i]].view(
            pk.npad[i], pk.kpad[i]).float()

    def WT(i, r0, rows):
        wt = pk.w[pk.wt_off[i]:pk.wt_off[i] + pk.npad[i] * pk.kpad[i]].view(pk.kpad[i], pk.npad[i])
        return wt[r0:r0 + rows].float()

    def lin(i, x):
        return (x @ W(i).t())[:, :pk.n[i]] + pk.b[pk.b_off[i]:pk.b_off[i] + pk.n[i]]

    def pad(x, width):
        return torch.nn.functional.pad(x, (0, width - x.shape[1]))

    L, width, feat_w = len(pk.k), pk.n[0], pk.n[bgf.FEATURE]
    pe = pad(bgf.fvm._pe(pts4, bgf.MULTIRES), bgf.PE_PAD)
    h, masks = pe, []
    for layer in range(bgf.D):
        z = lin(layer, h)
        masks.append(z > 0)
        h = torch.relu(z)
        if layer == bgf.SKIP:
            h = torch.cat([pe, h], dim=1)
            assert h.shape[1] == pk.kpad[layer + 1]
    density = lin(bgf.ALPHA, h)
    x = torch.cat([lin(bgf.FEATURE, h), bgf.fvm._pe(dirs, bgf.MULTIRES_VIEW)]
                  + ([] if a is None else [a]), dim=1)
    x = pad(x, pk.kpad[bgf.HEAD])
    for i in range(bgf.HEAD, L - 1):
        z = lin(i, x)
        masks.append(z > 0)
        x = torch.relu(z)
    rgb = lin(L - 1, x)

    g = (pad(c_rgb, pk.npad[L - 1]) @ WT(L - 1, 0, pk.kpad[L - 1]).t()) * masks[-1]
    for i in range(L - 2, bgf.HEAD, -1):
        g = (g @ WT(i, 0, pk.kpad[i]).t()) * masks[bgf.D + i - 1 - bgf.HEAD]
    gv = g @ WT(bgf.HEAD, feat_w, pk.kpad[bgf.HEAD] - feat_w).t()
    n_view = 3 * (1 + 2 * bgf.MULTIRES_VIEW)
    d_a = None if a is None else gv[:, n_view:n_view + a.shape[1]]
    g = g @ WT(bgf.HEAD, 0, feat_w).t()
    g = (g @ WT(bgf.FEATURE, 0, width).t() + c_den * W(bgf.ALPHA)[0]) * masks[bgf.D - 1]
    d_pe = 0.0
    for layer in range(bgf.D - 1, -1, -1):
        skip = layer == bgf.SKIP + 1
        if skip or layer == 0:
            d_pe = d_pe + (g @ WT(layer, 0, bgf.PE_PAD).t())[:, :bgf.D_PE]
        if layer > 0:
            g = (g @ WT(layer, bgf.PE_PAD if skip else 0, width).t()) * masks[layer - 1]
    return (density, rgb, bgf._pe_T(pts4, bgf.MULTIRES, d_pe),
            bgf._pe_T(dirs, bgf.MULTIRES_VIEW, gv[:, :n_view]), d_a)


@pytest.mark.parametrize("encode_a", [True, False])
def test_pack_bg_weights_drives_the_kernels_layout(encode_a):
    """The pack read as K8 / K9 read it (kernel_layout_pass) gives, in f32,
    the plain versions' density, rgb, d_pts4, d_dirs and d_a: the padded
    pts5, the head's view part and the split transposes line up with
    pack_layers' layout."""
    _, model, _, x, cots = make_case(encode_a, n=24, seed=5)
    ws, bs, tx = plain_args(model, encode_a, x)
    tc = [torch.from_numpy(c) for c in cots]
    pk = bgf.pack_bg_weights(ws, bs, "float32")
    got = kernel_layout_pass(pk, *tx, *tc)
    den, rgb = bgf.bg_fwd_plain(ws, bs, *tx, "float32")
    _, _, d_p4, d_dirs, d_a = bgf.bg_bwd_plain(ws, bs, *tx, *tc, "float32")
    for g, w in zip(got[:2], (den, rgb)):
        torch.testing.assert_close(g, w, atol=F32_ATOL, rtol=0)
    assert (got[4] is None) == (d_a is None)
    for g, w in zip(got[2:], (d_p4, d_dirs, d_a)):
        if w is not None:
            assert g.shape == w.shape and rel_l2(g.numpy(), w.numpy()) <= GRAD_REL


@pytest.mark.parametrize("encode_a", [True, False])
def test_bg_masks_read_the_kernels_rows(encode_a):
    """bg_masks on a workspace laid out as K9 leaves it (layer i's input in
    slot i, i - 1 past feature; pts5's [pe | h5] unpadded) gives the plain
    forward's ReLU signs, and the plain backward given those masks is the
    plain backward."""
    _, model, _, x, cots = make_case(encode_a, n=24, seed=6)
    ws, bs, tx = plain_args(model, encode_a, x)
    tc = [torch.from_numpy(c) for c in cots]
    pk = bgf.pack_bg_weights(ws, bs, "float32")
    res = bgf._forward(ws, bs, *tx, torch.float32)
    rows = 64
    work = torch.full((bgf.bwd_slots(pk.n_head) * rows * bgf.WMAX,), -1.0)
    view = work.view(-1, rows, bgf.WMAX)
    inputs = res["ins"][1:] + res["heads"]  # layers 1 .. 8, then 10 ..: slots 1 .. 8, 9 ..
    for slot, inp in enumerate(inputs, start=1):
        view[slot, :24, :inp.shape[1]] = inp
    masks = bgf.bg_masks(pk, work, rows, 24)
    zs = bgf.bg_preacts(ws, bs, *tx)
    assert len(masks) == len(zs) == bgf.D + pk.n_head
    for m, z in zip(masks, zs):
        assert m.shape == z.shape and torch.equal(m, z > 0)
    plain = bgf.bg_bwd_plain(ws, bs, *tx, *tc)
    given = bgf.bg_bwd_plain(ws, bs, *tx, *tc, masks=masks)
    for p, g in zip([*plain[0], *plain[1], *plain[2:]], [*given[0], *given[1], *given[2:]]):
        assert (p is None and g is None) or torch.equal(p, g)


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
