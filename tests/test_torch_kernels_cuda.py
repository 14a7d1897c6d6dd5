"""PyTorch port, the Hopper kernels against their plain versions on the
card. Marked ``cuda``; every test skips without a CUDA device. JAX is not
needed here (on a machine without JAX run with ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import copy
import os

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "config", "train_brandenburg_gate_tpu.yaml")

N_RAYS = 8192
# f32: summation order only. bf16: activations rounded to bf16 between
# layers; a value that rounds the other way moves sdf by a bf16 ulp
K1_F32_TOL, K1_BF16_ATOL = 1e-4, 2e-2
Z_ATOL = 1e-4
K2_RAY_FRAC = 0.999  # a draw can flip where a CDF value ties u
# the whole stage: K1's f32 rounding reaches K2's cosine through
# near-duplicate samples, so a few rays in a thousand draw elsewhere
STAGE_RAY_FRAC = 0.995


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def flagship(dev):
    """The served SDF net at full width with seeded noise on every weight
    and bias (``chip_smoke.live_sdf_net``), so that the PE columns, the
    skip's PE half and the biases, which the geometric init zeroes, all
    reach the output."""
    from chip_smoke import live_sdf_net
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg
    from neuralrecon_w_tpu_torch.models.neuconw import init_field

    fc = field_config_from_cfg(load_cfg(CONFIG))
    model = init_field(fc, torch.Generator().manual_seed(0), dev).requires_grad_(False)
    return fc, live_sdf_net(model.neuconw.sdf_net)


def rays(dev, seed=1):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn(N_RAYS, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, 0.9])
    d = -o + torch.randn(N_RAYS, 3, generator=g) * 0.05
    d = d / d.norm(dim=-1, keepdim=True)
    z = torch.sort(torch.rand(N_RAYS, 8, generator=g) * 1.5 + 0.05, dim=-1).values
    return o.to(dev), d.to(dev), z.to(dev)


# 1000: a ragged last tile; 102,144: the SDF sweep's chunk (scripts/sdf_extract.sh)
@pytest.mark.parametrize("n_pts", [N_RAYS, 1000, 102144])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_sdf_mlp_kernel_matches_plain(dev, flagship, act, n_pts):
    from neuralrecon_w_tpu_torch.ops import sdf_mlp

    fc, net = flagship
    pts = ((torch.rand(n_pts, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1)
           * 0.9).to(dev)
    packed = sdf_mlp.pack_sdf_weights(net, fc.sdf, act)
    before = sdf_mlp.fused_sdf_head.launches
    got = sdf_mlp.fused_sdf_head(packed, pts)
    want = sdf_mlp.sdf_mlp_plain(packed, pts)
    torch.cuda.synchronize()
    assert sdf_mlp.fused_sdf_head.launches == before + 1
    if act == "float32":
        torch.testing.assert_close(got, want, atol=K1_F32_TOL, rtol=K1_F32_TOL)
    else:
        assert float((got - want).abs().max()) <= K1_BF16_ATOL


def test_up_sample_kernel_matches_plain(dev, flagship):
    from neuralrecon_w_tpu_torch.ops import importance_sampler as smp
    from neuralrecon_w_tpu_torch.ops import sdf_mlp

    fc, net = flagship
    o, d, z = rays(dev)
    packed = sdf_mlp.pack_sdf_weights(net, fc.sdf, "float32")

    def sdf(zz):
        return sdf_mlp.sdf_mlp_plain(packed, (o[:, None] + d[:, None] * zz[..., None])
                                     .reshape(-1, 3)).view(zz.shape)

    mid = (o, d, z, sdf(z), None, None, 8, 512.0, False)
    got, want = smp.up_sample_round(*mid), smp.up_sample_round_plain(*mid)
    for g, w in zip(got, want):
        assert ((g - w).abs() <= Z_ATOL).all(dim=1).float().mean() >= K2_RAY_FRAC
    z1, s1, new = want
    last = (o, d, z1, s1, new, sdf(new), 8, 1024.0, True)
    got, want = smp.up_sample_round(*last), smp.up_sample_round_plain(*last)
    torch.cuda.synchronize()
    assert got.shape == (N_RAYS, 24)
    assert ((got - want).abs() <= Z_ATOL).all(dim=1).float().mean() >= K2_RAY_FRAC
    assert bool((torch.diff(got, dim=1) >= 0).all())


def test_importance_sampler_kernels_match_plain(dev, flagship):
    from neuralrecon_w_tpu_torch.ops import importance_sampler as smp

    fc, net = flagship
    o, d, z = rays(dev, seed=3)
    got = smp.fused_importance_sampler(net, fc.sdf, o, d, z, 16, 2, 3, "float32")
    want = smp.importance_sampler_plain(net, fc.sdf, o, d, z, 16, 2, 3, "float32")
    torch.cuda.synchronize()
    frac = ((got - want).abs() <= Z_ATOL).all(dim=1).float().mean().item()
    assert frac >= STAGE_RAY_FRAC, frac
    assert bool((torch.diff(got, dim=1) >= 0).all())


def sphere_sdf(o, d, z, radius=0.5):
    """The sdf of a sphere about the origin at the samples: the rays of
    rays() cross it twice."""
    return (o[:, None] + d[:, None] * z[..., None]).norm(dim=-1) - radius


def sorted_rows(dev, n_rays, width, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.sort(torch.rand(n_rays, width, generator=g) * 1.5 + 0.05, dim=-1).values.to(dev)


def ray_frac(got, want):
    return ((got - want).abs() <= Z_ATOL).all(dim=1).float().mean().item()


def k2_both(o, d, za, sa, zb, sb, n_draw, inv_s, last):
    from neuralrecon_w_tpu_torch.ops import importance_sampler as smp

    args = (o, d, za, sa, zb, sb, n_draw, inv_s, last)
    before = smp.up_sample_round.launches
    got, want = smp.up_sample_round(*args), smp.up_sample_round_plain(*args)
    torch.cuda.synchronize()
    assert smp.up_sample_round.launches == before + 1
    return (got,) if last else got, (want,) if last else want


# (na, nb, n_draw): one row width for each of K2's instantiations (lanes
# holding V = 1, 2, 4, 8, 16, 32 samples), each at its widest or just past
# the one below, and the first round of each (nb = 0)
@pytest.mark.parametrize("na,nb,n_draw", [(8, 8, 8), (8, 0, 8), (24, 8, 1), (30, 0, 2),
                                          (64, 32, 32), (128, 64, 64), (200, 0, 57),
                                          (256, 128, 128), (512, 384, 128), (1000, 0, 24)])
@pytest.mark.parametrize("last", [False, True])
def test_up_sample_kernel_every_row_width(dev, na, nb, n_draw, last):
    o, d, _ = rays(dev)
    n_rays = 2048
    o, d = o[:n_rays], d[:n_rays]
    za = sorted_rows(dev, n_rays, na, 11)
    zb = sorted_rows(dev, n_rays, nb, 12) if nb else None
    sa = sphere_sdf(o, d, za)
    sb = sphere_sdf(o, d, zb) if nb else None
    got, want = k2_both(o, d, za, sa, zb, sb, n_draw, 256.0, last)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert ray_frac(g, w) >= K2_RAY_FRAC
    if not last:  # the merge moves values and does no arithmetic
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((torch.diff(got[0], dim=1) >= 0).all())


def wide_rounds(dev, net, fc, n_rays, n0, n_importance, up_steps):
    """K2 alone in every round of an n0 + n_importance budget from inv_s 64,
    on identical inputs: each round's plain outputs feed the next round,
    the sdf from the plain MLP on the live net."""
    from neuralrecon_w_tpu_torch.ops import sdf_mlp

    o, d, _ = rays(dev, seed=5)
    o, d = o[:n_rays], d[:n_rays]
    z = sorted_rows(dev, n_rays, n0, 13)
    packed = sdf_mlp.pack_sdf_weights(net, fc.sdf, "float32")

    def sdf(zz):
        return sdf_mlp.sdf_mlp_plain(packed, (o[:, None] + d[:, None] * zz[..., None])
                                     .reshape(-1, 3)).view(zz.shape)

    n_per = n_importance // up_steps
    za, sa, zb, sb = z, sdf(z), None, None
    for i in range(up_steps):
        last = i + 1 == up_steps
        got, want = k2_both(o, d, za, sa, zb, sb, n_per, 64.0 * 2 ** i, last)
        for g, w in zip(got, want):
            assert ray_frac(g, w) >= K2_RAY_FRAC, (i, ray_frac(g, w))
        if last:
            assert got[0].shape == (n_rays, n0 + n_importance)
            assert bool((torch.diff(got[0], dim=1) >= 0).all())
        else:
            za, sa, zb = want
            sb = sdf(zb)


def test_up_sample_kernel_wide_budget(dev, flagship):
    """NeuS's own budget, 64 + 64 in 4 rounds (rows up to 128 wide)."""
    fc, net = flagship
    wide_rounds(dev, net, fc, N_RAYS, 64, 64, 4)


def test_up_sample_kernel_yacs_default_budget(dev, flagship):
    """The yacs defaults, N_SAMPLES 512 + N_IMPORTANCE 512 in 4 rounds:
    the last round writes rows of 1024, K2's widest."""
    fc, net = flagship
    wide_rounds(dev, net, fc, 1024, 512, 512, 4)


@pytest.mark.parametrize("n0,n_importance", [(64, 64), (512, 512)])
def test_importance_sampler_kernels_wide_budgets(dev, flagship, n0, n_importance):
    """The whole stage at budgets whose rows pass 64: the kernel path
    returns sorted samples that agree with the plain stage."""
    from neuralrecon_w_tpu_torch.ops import importance_sampler as smp

    fc, net = flagship
    o, d, _ = rays(dev, seed=6)
    o, d = o[:512], d[:512]
    z = sorted_rows(dev, 512, n0, 14)
    got = smp.fused_importance_sampler(net, fc.sdf, o, d, z, n_importance, 4, 0, "float32")
    want = smp.importance_sampler_plain(net, fc.sdf, o, d, z, n_importance, 4, 0, "float32")
    torch.cuda.synchronize()
    assert got.shape == (512, n0 + n_importance)
    assert ray_frac(got, want) >= STAGE_RAY_FRAC, ray_frac(got, want)
    assert bool((torch.diff(got, dim=1) >= 0).all())


@pytest.mark.parametrize("last", [False, True])
def test_up_sample_kernel_ties(dev, last):
    """Samples of b equal to samples of a: a's come first, each with its
    own sdf, as merge_sorted places them."""
    o, d, _ = rays(dev)
    za = sorted_rows(dev, N_RAYS, 16, 15)
    zb = torch.sort(torch.cat([za[:, ::2], za[:, 1:2]], dim=1), dim=1).values  # 9 ties a row
    sa = sphere_sdf(o, d, za)
    sb = sphere_sdf(o, d, zb) + 1e-3  # b's payload differs from a's at a tie
    got, want = k2_both(o, d, za, sa, zb, sb, 7, 512.0, last)
    if not last:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got, want):
        assert ray_frac(g, w) >= K2_RAY_FRAC


def test_up_sample_kernel_rays_that_miss_the_sphere(dev):
    """Rays outside the unit sphere, pointing away: every cosine is
    masked to 0 and the weights are flat, so the draws spread over the row."""
    n_rays = 1000
    g = torch.Generator().manual_seed(16)
    o = (torch.randn(n_rays, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, 1.5])).to(dev)
    d = torch.nn.functional.normalize(o + 0.05 * torch.randn(n_rays, 3, generator=g).to(dev),
                                      dim=-1)
    za = sorted_rows(dev, n_rays, 16, 17)
    sa = sphere_sdf(o, d, za)
    for last in (False, True):
        got, want = k2_both(o, d, za, sa, None, None, 16, 1024.0, last)
        for gg, w in zip(got, want):
            assert ray_frac(gg, w) >= K2_RAY_FRAC


@pytest.mark.parametrize("n_rays", [1, 3, 8189])
def test_up_sample_kernel_ragged_ray_counts(dev, n_rays):
    """Ray counts that do not fill the last block of 4 rays."""
    o, d, _ = rays(dev)
    o, d = o[:n_rays], d[:n_rays]
    za, zb = sorted_rows(dev, n_rays, 8, 18), sorted_rows(dev, n_rays, 8, 19)
    for last in (False, True):
        got, want = k2_both(o, d, za, sphere_sdf(o, d, za), zb, sphere_sdf(o, d, zb), 8,
                            1024.0, last)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert ray_frac(g, w) >= K2_RAY_FRAC


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(dev, flagship):
    from neuralrecon_w_tpu_torch.ops import importance_sampler as smp
    from neuralrecon_w_tpu_torch.ops import sdf_mlp

    fc, net = flagship
    packed = sdf_mlp.pack_sdf_weights(net, fc.sdf, "float32")
    with pytest.raises(ValueError):
        sdf_mlp.fused_sdf_head(packed, torch.zeros(8, 3, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):  # weights on the CPU, points on the card
        sdf_mlp.fused_sdf_head(packed._replace(w=packed.w.cpu()), torch.zeros(8, 3, device=dev))
    o, d, z = rays(dev)
    wide = torch.sort(torch.rand(N_RAYS, smp.MAX_WIDTH - 7, device=dev), dim=1).values
    with pytest.raises(ValueError, match=str(smp.MAX_WIDTH)):  # wider than K2's 1024
        smp.up_sample_round(o, d, wide, wide, None, None, 8, 512.0, True)
    with pytest.raises(ValueError):  # sdf rows that do not match z
        smp.up_sample_round(o, d, z, z[:, :4], None, None, 8, 512.0, True)


# ---------------- K3, K4, K5: the SDF-VJP kernels ----------------

# K3 f32: summation order only; bf16: the K1 bound
K3_F32_TOL = 1e-4
# K4 + K5 bf16 against the plain bf16 version (PERF.md, written before the
# first run): rel-L2 per dW, db and dx
VJP_BF16_REL = 5e-2


def vjp_inputs(net, n_pts, seed):
    from neuralrecon_w_tpu_torch.models.layers import layer_weight

    g = torch.Generator().manual_seed(seed)
    dev = net.lin0.bias.device
    x = ((torch.rand(n_pts, 3, generator=g) * 2 - 1) * 0.9).to(dev)
    n_out = net.layer(net.n_layers - 1).bias.shape[0]
    c_out = torch.randn(n_pts, n_out, generator=g).to(dev)
    c_grad = torch.randn(n_pts, 3, generator=g).to(dev)
    with torch.no_grad():
        ws = [layer_weight(net.layer(l)).detach().contiguous() for l in range(net.n_layers)]
    bs = [net.layer(l).bias.detach() for l in range(net.n_layers)]
    return ws, bs, x, c_out, c_grad


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))


@pytest.mark.parametrize("n_pts", [8192, 1000])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_sdf_vjp_forward_kernel_matches_plain(dev, flagship, act, n_pts):
    from neuralrecon_w_tpu_torch.ops import field_vjp_math as fvm
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    fc, net = flagship
    ws, bs, x, _, _ = vjp_inputs(net, n_pts, 4)
    cfg = dict(fc.sdf)
    before = vjp.sdf_vjp_fwd.launches
    out, grad = vjp.sdf_vjp_fwd(ws, bs, cfg, x, act)
    want_out, want_grad = fvm.value_and_grad(ws, bs, tuple(cfg["skip_in"]), cfg["multires"],
                                             float(cfg["scale"]), x, getattr(torch, act))
    torch.cuda.synchronize()
    assert vjp.sdf_vjp_fwd.launches == before + 1
    if act == "float32":
        torch.testing.assert_close(out, want_out, atol=K3_F32_TOL, rtol=K3_F32_TOL)
        torch.testing.assert_close(grad, want_grad, atol=K3_F32_TOL, rtol=K3_F32_TOL)
    else:
        assert float((out[:, 0] - want_out[:, 0]).abs().max()) <= K1_BF16_ATOL
        assert rel_l2(out, want_out) <= VJP_BF16_REL and rel_l2(grad, want_grad) <= VJP_BF16_REL


def test_sdf_vjp_backward_kernels_f32_against_f64(dev, flagship):
    """K4 + K5 in f32 lie as close to the float64 truth as the plain f32
    version does (the beta = 100 softplus makes f32 second order inexact)."""
    from neuralrecon_w_tpu_torch.ops import field_vjp_math as fvm
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    fc, net = flagship
    ws, bs, x, c_out, c_grad = vjp_inputs(net, 2048, 5)
    cfg = dict(fc.sdf)
    args = (tuple(cfg["skip_in"]), cfg["multires"], float(cfg["scale"]))
    got = vjp.sdf_vjp_bwd(ws, bs, cfg, x, c_out, c_grad, "float32")
    plain = fvm.vjp(ws, bs, *args, x, c_out, c_grad)
    truth = fvm.vjp([w.double() for w in ws], [b.double() for b in bs], *args, x.double(),
                    c_out.double(), c_grad.double(), torch.float64)
    torch.cuda.synchronize()
    flat = lambda r: [*r[0], *r[1], r[2]]  # noqa: E731
    for k, p, t in zip(flat(got), flat(plain), flat(truth)):
        assert rel_l2(k, t) <= max(2 * rel_l2(p, t), 1e-5), (rel_l2(k, t), rel_l2(p, t))


def test_sdf_vjp_backward_kernels_bf16_match_plain(dev, flagship, monkeypatch):
    """bf16, over several point chunks (a ragged last one)."""
    from neuralrecon_w_tpu_torch.ops import field_vjp_math as fvm
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    fc, net = flagship
    monkeypatch.setattr(vjp, "CHUNK", 1024)
    ws, bs, x, c_out, c_grad = vjp_inputs(net, 2500, 6)
    cfg = dict(fc.sdf)
    before = (vjp.sdf_vjp_bwd.launches, vjp.dw_reduce.launches)
    got = vjp.sdf_vjp_bwd(ws, bs, cfg, x, c_out, c_grad, "bfloat16")
    want = fvm.vjp(ws, bs, tuple(cfg["skip_in"]), cfg["multires"], float(cfg["scale"]), x,
                   c_out, c_grad, torch.bfloat16)
    torch.cuda.synchronize()
    assert vjp.sdf_vjp_bwd.launches == before[0] + 3
    assert vjp.dw_reduce.launches == before[1] + 3 * net.n_layers
    for k, w in zip([*got[0], *got[1], got[2]], [*want[0], *want[1], want[2]]):
        assert rel_l2(k, w) <= VJP_BF16_REL


def test_sdf_vjp_function_matches_double_backward(dev, flagship):
    """Through the autograd.Function, weight norm included: the kernels'
    gradients against the torch double backward, f32."""
    from neuralrecon_w_tpu_torch.models.sdf import sdf_value_feat_grad
    from neuralrecon_w_tpu_torch.ops.sdf_field_vjp import sdf_value_feat_grad_kernel

    fc, net = flagship
    net = copy.deepcopy(net).requires_grad_(True)
    _, _, x, c_out, c_grad = vjp_inputs(net, 1024, 7)

    def grads(fn):
        net.zero_grad()
        xx = x.clone().requires_grad_(True)
        s, f, g = fn(xx)
        (torch.sum(s * c_out[:, 0]) + torch.sum(f * c_out[:, 1:]) + torch.sum(g * c_grad)).backward()
        return [p.grad.clone() for p in net.parameters()] + [xx.grad]

    got = grads(lambda xx: sdf_value_feat_grad_kernel(net, fc.sdf, xx, "float32"))
    want = grads(lambda xx: sdf_value_feat_grad(net, fc.sdf_cfg, xx, torch.float32,
                                                create_graph=True))
    for k, w in zip(got, want):
        assert rel_l2(k, w) <= 1e-2


def check_sdf_vjp(ws, bs, cfg, x, c_out, c_grad, act):
    """K3, and K4 + K5, against the plain version: f32 K3 within K3_F32_TOL
    and K4 + K5 as close to float64 as the plain f32 (or 1e-5); bf16 within
    VJP_BF16_REL of the plain bf16."""
    from neuralrecon_w_tpu_torch.ops import field_vjp_math as fvm
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    args = (tuple(cfg["skip_in"]), cfg["multires"], float(cfg["scale"]))
    act_t = getattr(torch, act)
    out, grad = vjp.sdf_vjp_fwd(ws, bs, cfg, x, act)
    want_out, want_grad = fvm.value_and_grad(ws, bs, *args, x, act_t)
    flat = lambda r: [*r[0], *r[1], r[2]]  # noqa: E731
    got = flat(vjp.sdf_vjp_bwd(ws, bs, cfg, x, c_out, c_grad, act))
    plain = flat(fvm.vjp(ws, bs, *args, x, c_out, c_grad, act_t))
    torch.cuda.synchronize()
    for k in (out, grad, *got):
        assert bool(torch.isfinite(k).all())
    if act == "float32":
        torch.testing.assert_close(out, want_out, atol=K3_F32_TOL, rtol=K3_F32_TOL)
        torch.testing.assert_close(grad, want_grad, atol=K3_F32_TOL, rtol=K3_F32_TOL)
        truth = flat(fvm.vjp([w.double() for w in ws], [b.double() for b in bs], *args,
                             x.double(), c_out.double(), c_grad.double(), torch.float64))
        for k, p, t in zip(got, plain, truth):
            assert rel_l2(k, t) <= max(2 * rel_l2(p, t), 1e-5), (rel_l2(k, t), rel_l2(p, t))
    else:
        assert rel_l2(out, want_out) <= VJP_BF16_REL and rel_l2(grad, want_grad) <= VJP_BF16_REL
        for k, p in zip(got, plain):
            assert rel_l2(k, p) <= VJP_BF16_REL


# point counts the tile pass finds hard: fewer than one tile, one past a
# bf16 tile, and across a wrapper chunk boundary with a ragged last tile
EDGE_PTS = [37, 65, 1100]


@pytest.mark.parametrize("n_pts", EDGE_PTS)
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_sdf_vjp_kernels_at_tile_edges(dev, flagship, monkeypatch, act, n_pts):
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    fc, net = flagship
    monkeypatch.setattr(vjp, "CHUNK", 1024)
    ws, bs, x, c_out, c_grad = vjp_inputs(net, n_pts, 20 + n_pts)
    check_sdf_vjp(ws, bs, dict(fc.sdf), x, c_out, c_grad, act)


def skip_net(dev, skip: int, n_layers: int = 5, width: int = 256, multires: int = 6, seed=0):
    """Random weights of an SDF net with n_layers linear layers of the given
    width (a 1 + width wide output) and its skip at layer `skip`: the layer
    before it outputs width - d_pe, as the served net's does."""
    g = torch.Generator().manual_seed(seed + skip)
    d_pe = 3 * (1 + 2 * multires)
    ws, bs, k = [], [], d_pe
    for l in range(n_layers):
        n = 1 + width if l == n_layers - 1 else width - d_pe if l + 1 == skip else width
        ws.append((torch.randn(n, k, generator=g) / k ** 0.5).to(dev))
        bs.append((torch.randn(n, generator=g) * 0.05).to(dev))
        k = n + d_pe if l + 1 == skip else n
    return ws, bs, {"multires": multires, "scale": 1.0, "skip_in": (skip,)}


# every position make_net allows a skip at: not layer 0, not the last
@pytest.mark.parametrize("skip", [1, 2, 3])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_sdf_vjp_kernels_skip_positions(dev, act, skip):
    ws, bs, cfg = skip_net(dev, skip)
    g = torch.Generator().manual_seed(30 + skip)
    n = 300
    x = ((torch.rand(n, 3, generator=g) * 2 - 1) * 0.9).to(dev)
    c_out = torch.randn(n, ws[-1].shape[0], generator=g).to(dev)
    c_grad = torch.randn(n, 3, generator=g).to(dev)
    check_sdf_vjp(ws, bs, cfg, x, c_out, c_grad, act)


# ---------------- K6: the fused field forward ----------------

# f32: sdf and rgb summation order only, grad the K3 bound; bf16: rel-L2
# per output against the plain bf16 version, the SDF-VJP kernels' bound
K6_F32_TOL = 1e-4


@pytest.fixture(scope="module")
def field(dev):
    """The full-width field with the live SDF net (``chip_smoke.live_field``)."""
    from chip_smoke import live_field
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg
    from neuralrecon_w_tpu_torch.models.neuconw import init_field

    fc = field_config_from_cfg(load_cfg(CONFIG))
    model = init_field(fc, torch.Generator().manual_seed(0), dev).requires_grad_(False)
    return fc, live_field(model)


def field_inputs(fc, n_pts, dev, seed):
    g = torch.Generator().manual_seed(seed)
    pts = (torch.rand(n_pts, 3, generator=g) * 2 - 1) * 0.9
    dirs = torch.randn(n_pts, 3, generator=g)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    return pts.to(dev), dirs.to(dev), torch.randn(n_pts, fc.n_a, generator=g).to(dev)


@pytest.mark.parametrize("n_pts", [8192, 1000])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_field_forward_kernel_matches_plain(dev, field, act, n_pts):
    from neuralrecon_w_tpu_torch.ops import field_forward as ff

    fc, model = field
    fc = fc._replace(act_dtype=act)
    pts, dirs, a = field_inputs(fc, n_pts, dev, 8)
    pack = ff.pack_field(model, fc)
    before = ff.fused_field_forward.launches
    got = ff.fused_field_forward(model, fc, pts, dirs, a, pack)
    want = ff.field_forward_plain(pack, pts, dirs, a)
    torch.cuda.synchronize()
    assert ff.fused_field_forward.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        if act == "float32":
            torch.testing.assert_close(g, w, atol=K6_F32_TOL, rtol=K6_F32_TOL)
        else:
            assert rel_l2(g, w) <= VJP_BF16_REL


def test_field_forward_kernel_chunks(dev, field, monkeypatch):
    """Several launches, a ragged last one, stitched in place."""
    from neuralrecon_w_tpu_torch.ops import field_forward as ff

    fc, model = field
    fc = fc._replace(act_dtype="float32")
    monkeypatch.setattr(ff, "CHUNK", 1024)
    pts, dirs, a = field_inputs(fc, 2500, dev, 9)
    pack = ff.pack_field(model, fc)
    before = ff.fused_field_forward.launches
    got = ff.fused_field_forward(model, fc, pts, dirs, a, pack)
    want = ff.field_forward_plain(pack, pts, dirs, a)
    torch.cuda.synchronize()
    assert ff.fused_field_forward.launches == before + 3
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=K6_F32_TOL, rtol=K6_F32_TOL)


def test_field_forward_wrapper_rejects_what_the_kernel_does_not_take(dev, field):
    from neuralrecon_w_tpu_torch.ops import field_forward as ff

    fc, model = field
    pts, dirs, a = field_inputs(fc, 64, dev, 10)
    with pytest.raises(ValueError):  # appearance rows that do not match the points
        ff.fused_field_forward(model, fc, pts, dirs, a[:32])
    with pytest.raises(ValueError):
        ff.fused_field_forward(model, fc, pts.double(), dirs, a)


# ---------------- K7 (+ K6, K5): the fused field in training ----------------

# K7 + K5 f32 are held to the plain version in float64, as K4 + K5 are: the
# beta = 100 softplus makes f32 second order inexact. bf16 against the plain
# bf16 version, per output rel-L2, the SDF-VJP kernels' bound. The plain
# versions take the colour ReLU masks K7 applied: a pre-activation within
# rounding of 0 takes another sign in another summation order, and those
# masks may differ from the reference's own signs only there
# (chip_smoke.FLIP_Z, PERF.md)
FIELD_TRAIN_BF16_REL = 5e-2
FLIP_Z = {"float32": 1e-3, "bfloat16": 5e-2}


def assert_flips_near_zero(masks, zs, tol):
    for m, z in zip(masks, zs):
        flip = m != (z > 0)
        if bool(flip.any()):
            assert float(z[flip].abs().max()) <= tol * float(z.double().square().mean().sqrt())


def field_train_case(fc, model, act, n_pts, dev, seed):
    from neuralrecon_w_tpu_torch.ops import field_train as ft

    spec = ft.field_spec(model, fc._replace(act_dtype=act))
    with torch.no_grad():
        wb = [t.detach().contiguous() for t in ft.field_weights(model)]
    pts, dirs, a = field_inputs(fc, n_pts, dev, seed)
    g = torch.Generator().manual_seed(seed + 100)
    cots = [torch.randn(n_pts, 3, generator=g).to(dev), torch.randn(n_pts, generator=g).to(dev),
            torch.randn(n_pts, 3, generator=g).to(dev)]
    return spec, wb, (pts, dirs, a, *cots)


def flat_field_grads(r):
    return [*r[0], *r[1], *r[2], *r[3], r[4], r[5], r[6]]


def test_field_train_backward_f32_against_f64(dev, field):
    from neuralrecon_w_tpu_torch.ops import field_train as ft

    fc, model = field
    spec, wb, args = field_train_case(fc, model, "float32", 2048, dev, 11)
    before = ft.field_train_bwd.launches
    masks = []
    got = ft.field_train_bwd(ft.pack_field_tensors(spec, wb), *args, masks=masks)
    plain = ft.field_train_bwd_plain(spec, wb, *args, masks=masks)
    wb64, args64 = [w.double() for w in wb], [t.double() for t in args]
    truth = ft.field_train_bwd_plain(spec, wb64, *args64, masks=masks)
    torch.cuda.synchronize()
    assert ft.field_train_bwd.launches == before + 1
    assert_flips_near_zero(masks, ft.color_preacts(spec, wb64, *args64[:3]), FLIP_Z["float32"])
    for k, p, t in zip(flat_field_grads(got), flat_field_grads(plain), flat_field_grads(truth)):
        assert k.shape == t.shape and bool(torch.isfinite(k).all())
        assert rel_l2(k, t) <= max(2 * rel_l2(p, t), 1e-5), (rel_l2(k, t), rel_l2(p, t))


def test_field_train_backward_bf16_matches_plain(dev, field, monkeypatch):
    """bf16, over several point chunks (a ragged last one)."""
    from neuralrecon_w_tpu_torch.ops import field_train as ft
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    fc, model = field
    monkeypatch.setattr(ft, "CHUNK", 1024)
    spec, wb, args = field_train_case(fc, model, "bfloat16", 2500, dev, 12)
    before = (ft.field_train_bwd.launches, vjp.dw_reduce.launches)
    masks = []
    got = ft.field_train_bwd(ft.pack_field_tensors(spec, wb), *args, masks=masks)
    want = ft.field_train_bwd_plain(spec, wb, *args, masks=masks)
    torch.cuda.synchronize()
    n_color = len(wb) // 2 - spec.n_sdf
    assert ft.field_train_bwd.launches == before[0] + 3
    # per chunk: every SDF layer, every colour layer, the static head's first twice
    assert vjp.dw_reduce.launches == before[1] + 3 * (spec.n_sdf + n_color + 1)
    assert [m.shape[0] for m in masks] == [2500] * (n_color - 2)
    assert_flips_near_zero(masks, ft.color_preacts(spec, wb, *args[:3]), FLIP_Z["bfloat16"])
    for k, w in zip(flat_field_grads(got), flat_field_grads(want)):
        assert rel_l2(k, w) <= FIELD_TRAIN_BF16_REL


def test_field_train_function_matches_double_backward(dev, field):
    """Through field_forward's 'pallas_field' mode (K6 forward, K7 + K5
    backward, the weight norm in autograd) against the 'vjp' mode's torch
    double backward, f32, per-ray dirs and a, every parameter's gradient."""
    from neuralrecon_w_tpu_torch.models.neuconw import field_forward

    fc, model = field
    fc = fc._replace(act_dtype="float32")
    n_rays, n_samples = 128, 16
    pts, dirs, a = field_inputs(fc, n_rays * n_samples, dev, 13)
    dirs, a = dirs[:n_rays], a[:n_rays]
    g = torch.Generator().manual_seed(14)
    c = [torch.randn(n_rays * n_samples, 3, generator=g).to(dev),
         torch.randn(n_rays * n_samples, generator=g).to(dev),
         torch.randn(n_rays * n_samples, 3, generator=g).to(dev)]

    def grads(mode):
        m = copy.deepcopy(model).requires_grad_(True)
        xs = [t.clone().requires_grad_(True) for t in (pts, dirs, a)]
        rgb, _, sdf, grad, _ = field_forward(m, fc._replace(grad_mode=mode), *xs, n_samples,
                                             create_graph=True)
        (torch.sum(rgb * c[0]) + torch.sum(sdf * c[1]) + torch.sum(grad * c[2])).backward()
        return {k: p.grad for k, p in m.named_parameters() if "_net." in k} | {
            f"x{i}": x.grad for i, x in enumerate(xs)}

    got, want = grads("pallas_field"), grads("vjp")
    assert set(got) == set(want)
    for k in want:
        assert rel_l2(got[k], want[k]) <= 1e-2, k


@pytest.mark.parametrize("n_pts", EDGE_PTS)
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_field_kernels_at_tile_edges(dev, field, monkeypatch, act, n_pts):
    """K6 and K7 + K5 at the point counts the tile pass finds hard, over
    1024-point wrapper chunks, against the plain versions (K7 in f32 against
    float64, as the plain f32 is)."""
    from neuralrecon_w_tpu_torch.ops import field_forward as ff
    from neuralrecon_w_tpu_torch.ops import field_train as ft

    fc, model = field
    monkeypatch.setattr(ff, "CHUNK", 1024)
    monkeypatch.setattr(ft, "CHUNK", 1024)
    spec, wb, args = field_train_case(fc, model, act, n_pts, dev, 40 + n_pts)
    pack = ft.pack_field_tensors(spec, wb)
    got = ff.field_forward_kernel(pack, *args[:3])
    want = ff.field_forward_plain(pack, *args[:3])
    masks = []
    grads = flat_field_grads(ft.field_train_bwd(pack, *args, masks=masks))
    plain = flat_field_grads(ft.field_train_bwd_plain(spec, wb, *args, masks=masks))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        if act == "float32":
            torch.testing.assert_close(g, w, atol=K6_F32_TOL, rtol=K6_F32_TOL)
        else:
            assert rel_l2(g, w) <= VJP_BF16_REL
    if act == "float32":
        wb64, args64 = [w.double() for w in wb], [t.double() for t in args]
        truth = flat_field_grads(ft.field_train_bwd_plain(spec, wb64, *args64, masks=masks))
        assert_flips_near_zero(masks, ft.color_preacts(spec, wb64, *args64[:3]), FLIP_Z[act])
        for k, p, t in zip(grads, plain, truth):
            assert bool(torch.isfinite(k).all())
            assert rel_l2(k, t) <= max(2 * rel_l2(p, t), 1e-5), (rel_l2(k, t), rel_l2(p, t))
    else:
        assert_flips_near_zero(masks, ft.color_preacts(spec, wb, *args[:3]), FLIP_Z[act])
        for k, p in zip(grads, plain):
            assert rel_l2(k, p) <= FIELD_TRAIN_BF16_REL


# ---------------- K8, K9 (+ K5): the fused background ----------------

# f32: K8 summation order only; K9's gradients against the plain f32 version
# (first order: f32 sums in another order). bf16: per output rel-L2.
BG_F32_TOL, BG_GRAD_REL, BG_BF16_REL = 1e-4, 1e-5, 5e-2


def bg_case(encode_a, n_pts, dev, seed):
    from neuralrecon_w_tpu_torch.models.nerf_bg import NeRF, init_nerf_bg_
    from neuralrecon_w_tpu_torch.ops import nerf_bg_fused as bgf

    net = NeRF(encode_a, 48, dev)
    init_nerf_bg_(net, torch.Generator().manual_seed(seed))
    layers = bgf.bg_layers(net, encode_a)
    ws = [m.weight.detach() for m in layers]
    bs = [m.bias.detach() for m in layers]
    g = torch.Generator().manual_seed(seed + 1)
    xyz = torch.randn(n_pts, 3, generator=g)
    pts4 = torch.cat([xyz / xyz.norm(dim=-1, keepdim=True),
                      torch.rand(n_pts, 1, generator=g) * 0.95 + 0.05], dim=-1)
    dirs = torch.randn(n_pts, 3, generator=g)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    a = torch.randn(n_pts, 48, generator=g) if encode_a else None
    cots = [torch.randn(n_pts, 1, generator=g), torch.randn(n_pts, 3, generator=g)]
    to = lambda t: None if t is None else t.to(dev)  # noqa: E731
    return ws, bs, [to(t) for t in (pts4, dirs, a)], [to(t) for t in cots]


def flat_bg_grads(r):
    return [*r[0], *r[1], *[t for t in r[2:] if t is not None]]


@pytest.mark.parametrize("encode_a", [True, False])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_nerf_bg_kernels_match_plain(dev, encode_a, act, monkeypatch):
    """K8 and K9 + K5 over several point chunks (a ragged last one)."""
    from neuralrecon_w_tpu_torch.ops import nerf_bg_fused as bgf

    monkeypatch.setattr(bgf, "CHUNK", 2048)
    ws, bs, x, cots = bg_case(encode_a, 5000, dev, 15)
    pk = bgf.pack_bg_weights(ws, bs, act)
    before = (bgf.nerf_bg_fwd.launches, bgf.nerf_bg_bwd.launches)
    got = bgf.nerf_bg_fwd(pk, *x)
    want = bgf.bg_fwd_plain(ws, bs, *x, act)
    got_b = bgf.nerf_bg_bwd(pk, *x, *cots)
    want_b = bgf.bg_bwd_plain(ws, bs, *x, *cots, act)
    torch.cuda.synchronize()
    assert (bgf.nerf_bg_fwd.launches, bgf.nerf_bg_bwd.launches) == (before[0] + 3, before[1] + 3)
    assert (got_b[4] is None) == (not encode_a)
    for k, w in zip(got, want):
        if act == "float32":
            torch.testing.assert_close(k, w, atol=BG_F32_TOL, rtol=BG_F32_TOL)
        else:
            assert rel_l2(k, w) <= BG_BF16_REL
    for k, w in zip(flat_bg_grads(got_b), flat_bg_grads(want_b)):
        assert k.shape == w.shape
        assert rel_l2(k, w) <= (BG_GRAD_REL if act == "float32" else BG_BF16_REL)


# K8 / K9 at the point counts the tile pass finds hard: fewer than one
# 64-point tile, one more than a tile, one more than a wrapper chunk
BG_EDGE_PTS = [37, 65, 2049]


@pytest.mark.parametrize("n_pts", BG_EDGE_PTS)
@pytest.mark.parametrize("encode_a", [True, False])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_nerf_bg_kernels_at_tile_edges(dev, encode_a, act, n_pts, monkeypatch):
    """K8 and K9 + K5 over 2048-point wrapper chunks against the plain
    versions, the plain backward taking the ReLU masks K9 applied; a mask
    may differ from the plain forward's sign only within rounding of 0."""
    from neuralrecon_w_tpu_torch.ops import nerf_bg_fused as bgf

    monkeypatch.setattr(bgf, "CHUNK", 2048)
    ws, bs, x, cots = bg_case(encode_a, n_pts, dev, 20 + n_pts)
    pk = bgf.pack_bg_weights(ws, bs, act)
    before = (bgf.nerf_bg_fwd.launches, bgf.nerf_bg_bwd.launches)
    got = bgf.nerf_bg_fwd(pk, *x)
    want = bgf.bg_fwd_plain(ws, bs, *x, act)
    masks = []
    got_b = bgf.nerf_bg_bwd(pk, *x, *cots, masks=masks)
    want_b = bgf.bg_bwd_plain(ws, bs, *x, *cots, act, masks=masks)
    torch.cuda.synchronize()
    chunks = (n_pts + 2047) // 2048
    assert (bgf.nerf_bg_fwd.launches, bgf.nerf_bg_bwd.launches) == (before[0] + chunks,
                                                                    before[1] + chunks)
    assert_flips_near_zero(masks, bgf.bg_preacts(ws, bs, *x, act), FLIP_Z[act])
    for k, w in zip(got, want):
        assert k.shape == w.shape and bool(torch.isfinite(k).all())
        if act == "float32":
            torch.testing.assert_close(k, w, atol=BG_F32_TOL, rtol=BG_F32_TOL)
        else:
            assert rel_l2(k, w) <= BG_BF16_REL
    for k, w in zip(flat_bg_grads(got_b), flat_bg_grads(want_b)):
        assert k.shape == w.shape and bool(torch.isfinite(k).all())
        assert rel_l2(k, w) <= (BG_GRAD_REL if act == "float32" else BG_BF16_REL)


def test_nerf_bg_function_matches_autograd(dev):
    """Through field_background's 'pallas' mode (K8, K9 + K5) against the
    'xla' mode's autograd, f32, per-ray dirs and a."""
    from neuralrecon_w_tpu_torch.models.neuconw import field_background

    fc, model = field_config_and_model(dev)
    n_rays, k = 256, 11
    ws, bs, (pts4, dirs, a), (c_den, c_rgb) = bg_case(True, n_rays * k, dev, 16)

    def grads(mode):
        m = copy.deepcopy(model).requires_grad_(True)
        xs = [t.clone().requires_grad_(True) for t in (pts4, dirs[:n_rays], a[:n_rays])]
        den, rgb = field_background(m, fc._replace(bg_mode=mode, act_dtype="float32"), *xs, k)
        (torch.sum(den * c_den) + torch.sum(rgb * c_rgb)).backward()
        return {n: p.grad for n, p in m.named_parameters() if n.startswith("nerf.")} | {
            f"x{i}": x.grad for i, x in enumerate(xs)}

    got, want = grads("pallas"), grads("xla")
    assert set(got) == set(want)
    for name in want:
        assert rel_l2(got[name], want[name]) <= 1e-4, name


def field_config_and_model(dev):
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg
    from neuralrecon_w_tpu_torch.models.neuconw import init_field

    fc = field_config_from_cfg(load_cfg(CONFIG))
    return fc, init_field(fc, torch.Generator().manual_seed(0), dev).requires_grad_(False)



# K5 at the widths the paths give it: an SDF layer's two factor pairs (the
# first layer's k 39, the output layer's n 513, a 3-wide and a 256-wide
# layer) and one pair at a dW row stride past k (the static head's 587-wide
# input splits into 512 + 75 columns), from 16-byte aligned rows and from
# rows one float off (a colour layer's input starts at column 1); point
# counts off the 32-point slabs and below the split count
@pytest.mark.parametrize("n_pts", [2900, 37])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_dw_reduce_layer_matches_torch(dev, act, n_pts):
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    g = torch.Generator().manual_seed(17)
    shapes = [(513, 39), (3, 256), (256, 512)]  # (n, k) per layer
    ws = [torch.randn(n, k, generator=g).to(dev) for n, k in shapes]
    bs = [torch.randn(n, generator=g).to(dev) for n, _ in shapes]
    pk = vjp.pack_vjp_weights(ws, bs, {"multires": 6, "scale": 1.0, "skip_in": ()}, act)
    work, rows = vjp.workspace(n_pts, 6, len(shapes), dev)
    work.normal_(generator=torch.Generator(dev).manual_seed(18))
    view = work.view(6, len(shapes), rows, vjp.WMAX)
    rnd = (lambda t: t.double()) if act == "float32" else (lambda t: t.bfloat16().double())
    before = vjp.dw_reduce.launches
    for l, (n, k) in enumerate(shapes):
        dW = torch.zeros(n, k, device=dev)
        db = torch.zeros(n, device=dev)
        vjp.dw_reduce(pk, work, rows, l, n_pts, dW, db)
        d, r, gt, u = (view[kind, l, :n_pts] for kind in (2, 4, 5, 0))
        want = rnd(d[:, :n]).t() @ rnd(r[:, :k]) + rnd(gt[:, :n]).t() @ rnd(u[:, :k])
        torch.cuda.synchronize()
        torch.testing.assert_close(dW.double(), want, atol=1e-2, rtol=1e-4)
        torch.testing.assert_close(db.double(), gt[:, :n].double().sum(0), atol=1e-3, rtol=1e-4)
    assert vjp.dw_reduce.launches == before + len(shapes)


@pytest.mark.parametrize("x_shift", [0, 1])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_dw_reduce_rows_matches_torch(dev, act, x_shift):
    """K5's one-pair entry into a column slice of a wider dW, with and
    without db."""
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    rows, n_pts = 3000, 2899
    work = torch.randn(2 * rows * vjp.WMAX, device=dev,
                       generator=torch.Generator(dev).manual_seed(19))
    rnd = (lambda t: t.double()) if act == "float32" else (lambda t: t.bfloat16().double())
    y_off = rows * vjp.WMAX + 1  # a colour layer's input row starts at column 1
    for n, k, c0 in [(128, 512, 0), (128, 75, 512), (513, 39, 3), (100, 297, 50)]:
        dW = torch.zeros(n, 600, device=dev)
        db = torch.zeros(n, device=dev)
        vjp.dw_reduce_rows(work, x_shift, y_off, n, k, n_pts, act, dW[:, c0:c0 + k], db)
        vjp.dw_reduce_rows(work, x_shift, y_off, n, k, n_pts, act, dW[:, c0:c0 + k])
        x = work[x_shift:x_shift + rows * vjp.WMAX].view(rows, vjp.WMAX)[:n_pts, :n]
        y = work[y_off:].as_strided((n_pts, k), (vjp.WMAX, 1))
        torch.cuda.synchronize()
        torch.testing.assert_close(dW[:, c0:c0 + k].double(), 2 * rnd(x).t() @ rnd(y),
                                   atol=1e-2, rtol=1e-4)
        assert float(dW[:, :c0].abs().sum()) == 0.0 and float(dW[:, c0 + k:].abs().sum()) == 0.0
        torch.testing.assert_close(db.double(), x.double().sum(0), atol=1e-3, rtol=1e-4)


# ----------------------- K10 / K11: the grid queries -----------------------


def random_words(level, dev, seed, density_shift=5):
    """A level-``level`` bitfield, each bit set with probability
    2^-density_shift (one in 32 cells occupied by default)."""
    g = torch.Generator(dev).manual_seed(seed)
    n_words = max((1 << (3 * level)) // 32, 1)
    words = torch.full((n_words,), -1, dtype=torch.int32, device=dev)
    for _ in range(density_shift):
        words &= torch.randint(-2**31, 2**31 - 1, (n_words,), dtype=torch.int32, device=dev,
                               generator=g)
    return words


def grid_rays(level, words, n, dev, seed):
    """Rays in normalised coordinates: from outside toward the cube,
    axis-parallel ones (two components exactly 0, or one), ones from the
    centres of occupied cells, and misses pointing away from the cube."""
    from chip_smoke import level10_rays
    from neuralrecon_w_tpu_torch.ops.voxel_grid import VoxelGrid, _from_linear

    head = words[:1 << 16].cpu()  # the occupied cells among the first 2^21
    bits = ((head.view(-1, 1) >> torch.arange(32, dtype=torch.int32)) & 1).view(-1)
    occ = torch.nonzero(bits).view(-1).numpy()
    host = VoxelGrid(level, [0.0, 0.0, 0.0], 1.0, _from_linear(occ, level))
    o, d = level10_rays(host, n, seed)
    return torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)


@pytest.mark.parametrize("first_only", [False, True])
@pytest.mark.parametrize("level", list(range(1, 11)))
def test_dda_kernel_matches_plain_bit_for_bit(dev, level, first_only):
    """K10 against the plain DDA at every level 1-10, every output equal:
    the kernel runs the plain version's float32 arithmetic unfused."""
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    words = random_words(level, dev, seed=level, density_shift=3 if level < 4 else 6)
    o, d = grid_rays(level, words, 4096 if level < 10 else 2048, dev, seed=level)
    before = rv.dda_traverse.launches
    trips = torch.empty(o.shape[0], dtype=torch.int32, device=dev)
    got = rv.dda_traverse(words, level, o, d, first_only, steps_out=trips)
    touched = torch.zeros_like(words)
    want = rv.dda_traverse_plain(words, level, o, d, first_only, touched=touched)
    torch.cuda.synchronize()
    assert rv.dda_traverse.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[2].any()) and bool((~got[2]).any())
    assert int(trips.max()) <= 3 * (1 << level) + 2
    # the plain version's read count (chip_smoke's bytes bound) is K10's trips
    assert int(touched.sum()) == int(trips.sum())


@pytest.mark.parametrize("n_rays", [1, 3, 1000, 8189])
@pytest.mark.parametrize("n_samples", [1, 64, 1024])
def test_sampled_hit_kernel_matches_plain_bit_for_bit(dev, n_samples, n_rays):
    """K11 against the plain sampled query at 1, 64 and 1024 samples and
    ragged ray counts: every output equal."""
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    level = 7
    words = random_words(level, dev, seed=n_rays, density_shift=4)
    grid = rv.DeviceGrid(words, torch.zeros(3, device=dev), 1.0, 2.0 / (1 << level))
    o, d = grid_rays(level, words, max(n_rays, 4), dev, seed=n_samples)
    o, d = o[:n_rays].contiguous(), d[:n_rays].contiguous()
    g = torch.Generator(dev).manual_seed(n_samples)
    t_lo = torch.rand(n_rays, device=dev, generator=g)
    t_hi = t_lo + 3.0 * torch.rand(n_rays, device=dev, generator=g)
    before = rv.sampled_first_hit.launches
    steps, plain_steps = (torch.empty(n_rays, dtype=torch.int32, device=dev) for _ in range(2))
    got = rv.sampled_first_hit(grid, level, o, d, t_lo, t_hi, n_samples, steps_out=steps)
    want = rv.sampled_first_hit_plain(grid, level, o, d, t_lo, t_hi, n_samples,
                                      steps_out=plain_steps)
    torch.cuda.synchronize()
    assert rv.sampled_first_hit.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(steps, plain_steps)


def test_grid_query_wrappers_reject_what_the_kernels_do_not_take(dev):
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    words = random_words(4, dev, seed=0)
    o = torch.zeros(8, 3, device=dev)
    with pytest.raises(ValueError):
        rv.dda_traverse(words, 5, o, o)  # a level-5 grid has more words
    with pytest.raises(ValueError):
        rv.dda_traverse(words, 4, o.double(), o.double())
    with pytest.raises(ValueError):
        rv.dda_traverse(words.cpu(), 4, o, o)
    with pytest.raises(ValueError):
        rv.coarse_mask(words, 5)


def clustered_grid(level, kind, seed=0):
    """A host grid whose K10 mask blocks are some empty and some occupied:
    'shell', chip_smoke's shell of radius 0.8 (two cells thick, at least
    one at the coarse levels); 'blocks', one in 16 of the mask's blocks
    occupied, each by a few random cells."""
    import numpy as np

    from chip_smoke import shell_coords
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv
    from neuralrecon_w_tpu_torch.ops.voxel_grid import VoxelGrid, _sort_coords

    rng = np.random.default_rng(seed)
    n = 1 << level
    if kind == "shell":
        coords = shell_coords(level, 1.0, 0.8, max(2.0, n / 64))
    else:
        b = 1 << rv.mask_shift(level)
        nc = n // b
        blocks = rng.integers(0, nc, (max(nc ** 3 // 16, 1), 3))
        coords = (blocks[:, None, :] * b + rng.integers(0, b, (len(blocks), 4, 3))).reshape(-1, 3)
    return VoxelGrid(level, np.zeros(3), 1.0, _sort_coords(coords, level))


def check_dda(dev, host, o, d, first_only):
    """K10 against the plain DDA on a host grid's words: every output, each
    ray's trips, and the plain version's read count; returns (trips, the
    trips that read the global word)."""
    import numpy as np

    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    words = torch.from_numpy(host.occupancy_words().view(np.int32)).to(dev)
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    r = o.shape[0]
    trips, plain_trips, reads = (torch.empty(r, dtype=torch.int32, device=dev)
                                 for _ in range(3))
    touched = torch.zeros_like(words)
    before = rv.dda_traverse.launches
    got = rv.dda_traverse(words, host.level, o, d, first_only, steps_out=trips)
    want = rv.dda_traverse_plain(words, host.level, o, d, first_only, touched=touched,
                                 steps_out=plain_trips, global_reads=reads)
    torch.cuda.synchronize()
    assert rv.dda_traverse.launches == before + 1  # the pre-pass is not counted
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(trips, plain_trips)
    assert int(touched.sum()) == int(trips.sum())
    return trips, reads


@pytest.mark.parametrize("kind", ["shell", "blocks"])
@pytest.mark.parametrize("first_only", [False, True])
@pytest.mark.parametrize("level", list(range(1, 11)))
def test_dda_kernel_on_clustered_grids(dev, level, first_only, kind):
    """K10 bit for bit against the plain DDA on grids whose mask blocks are
    empty and occupied both (at random words every block is occupied, so
    the skip would never run), over level10_rays's four kinds: from
    outside, axis parallel, from inside the cube (occupied cells), misses.
    From MASK_FROM up both of a step's branches run: the mask skips some
    global reads and not all; below it every trip reads."""
    from chip_smoke import level10_rays
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    host = clustered_grid(level, kind, seed=level)
    o, d = level10_rays(host, 4096, seed=level)
    trips, reads = check_dda(dev, host, o, d, first_only)
    if level >= rv.MASK_FROM:
        assert 0 < int(reads.sum()) < int(trips.sum())
    else:
        assert torch.equal(reads, trips)


@pytest.mark.parametrize("first_only", [False, True])
@pytest.mark.parametrize("n_rays", [1, 3, 8189, 300001])
def test_dda_kernel_ragged_ray_counts(dev, n_rays, first_only):
    """K10 at ragged ray counts on the level-8 shell: one block of a warp
    (1, 3), warps of blocks of 32 (8189), blocks of 256 with a ragged last
    one (300,001)."""
    import numpy as np

    from chip_smoke import level10_rays

    host = clustered_grid(8, "shell")
    o, d = level10_rays(host, max(n_rays, 4), seed=n_rays)
    check_dda(dev, host, np.ascontiguousarray(o[:n_rays]), np.ascontiguousarray(d[:n_rays]),
              first_only)


@pytest.mark.parametrize("kind", ["shell", "blocks", "random"])
@pytest.mark.parametrize("level", list(range(1, 11)))
def test_coarse_mask_matches_plain(dev, level, kind):
    """K10's pre-pass against its plain version (the words themselves at
    MASK_LEVEL and below), on clustered grids and on random words, whose
    every block is occupied."""
    import numpy as np

    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    words = (random_words(level, dev, seed=level) if kind == "random" else
             torch.from_numpy(clustered_grid(level, kind, seed=level).occupancy_words()
                              .view(np.int32)).to(dev))
    got = rv.coarse_mask(words, level)
    torch.cuda.synchronize()
    want = rv.coarse_words_plain(words, level, rv.mask_shift(level))
    if level <= rv.MASK_LEVEL:
        # the grid is its own mask; the plain mask drops the bits past the
        # cells of a grid under one word (levels 0 and 1), which no step reads
        assert torch.equal(got, words)
        cells = 1 << (3 * level)
        got = got & ((1 << cells) - 1 if cells < 32 else -1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("first", [0, 31, 32, 33, 512, None])
def test_sampled_hit_kernel_warp_edges(dev, first):
    """K11 with the first hit at sample 0, 31, 32 and 33 (either side of
    the first round's edge), at 512 with the samples before it outside the
    cube over an occupied clamped cell, and missing all 1024 samples.
    Rays run along z through the level-10 grid, so sample k is the centre of
    z-cell k; each ray's column holds its first hit's cell and some after
    it."""
    import numpy as np

    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv
    from neuralrecon_w_tpu_torch.ops.voxel_grid import VoxelGrid, _sort_coords

    level, n_rays, k = 10, 96, 1024
    n = 1 << level
    rng = np.random.default_rng(0 if first is None else first)
    cols = rng.choice(n * n, n_rays, replace=False)
    x, y = cols // n, cols % n
    outside = first == 512  # samples 0-511 lie before z = -1, their cell clamped to z-cell 0
    hit_at = 0 if outside else first
    coords = []
    if first is not None:
        later = rng.integers(hit_at + 1, n, (n_rays, 3))
        coords = [np.stack([x, y, z], 1) for z in (np.full(n_rays, hit_at), *later.T)]
    # occupied cells off the rays' columns, so that a miss walks a grid that is not empty
    noise = rng.integers(0, n, (4096, 3))
    coords.append(noise[~np.isin(noise[:, 0] * n + noise[:, 1], cols)])
    host = VoxelGrid(level, np.zeros(3), 1.0, _sort_coords(np.concatenate(coords), level))
    words = torch.from_numpy(host.occupancy_words().view(np.int32)).to(dev)
    grid = rv.DeviceGrid(words, torch.zeros(3, device=dev), 1.0, 2.0 / n)
    centre = lambda c: (c + 0.5) * 2.0 / n - 1.0  # noqa: E731
    o = torch.as_tensor(np.stack([centre(x), centre(y), np.full(n_rays, -2.0)], 1),
                        dtype=torch.float32, device=dev)
    d = torch.zeros_like(o)
    d[:, 2] = 1.0
    t_lo = torch.full((n_rays,), 0.0 if outside else 1.0, device=dev)
    t_hi = t_lo + 2.0
    steps, plain_steps = (torch.empty(n_rays, dtype=torch.int32, device=dev) for _ in range(2))
    got = rv.sampled_first_hit(grid, level, o, d, t_lo, t_hi, k, steps_out=steps)
    want = rv.sampled_first_hit_plain(grid, level, o, d, t_lo, t_hi, k, steps_out=plain_steps)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(steps, plain_steps)
    assert int((plain_steps == (k if first is None else first + 1)).sum()) == n_rays
    assert bool(got[1].all()) if first is not None else not bool(got[1].any())


def test_captured_step_matches_eager(dev):
    """make_scan_train_fn's CUDA graph against the same window of eager
    steps from one state (chip_smoke.graph_parity at a narrow width): f32 at
    PERTURB 0 within GRAPH_LOSS_RTOL / GRAPH_PARAM_REL, the operating
    point's mean loss within GRAPH_MEAN_REL."""
    import chip_smoke as cs
    from neuralrecon_w_tpu_torch.config import load_cfg
    from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool, RayPool
    from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
    from neuralrecon_w_tpu_torch.training.schedule import make_optimizer
    from neuralrecon_w_tpu_torch.training.step import init_state

    cfg = load_cfg(CONFIG)
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
    n.SDF_CONFIG.skip_in = (2,)
    n.COLOR_CONFIG.d_feature, n.COLOR_CONFIG.d_hidden, n.COLOR_CONFIG.n_layers = 64, 32, 2
    n.N_VOCAB = 16
    rows, rgbs = cs.training_rays(n_cams=4, wh=(40, 30))
    pool = DeviceRayPool(RayPool(rows, rgbs, seed=0), dev)
    spec, _ = make_optimizer(cfg, 512)
    state = init_state(cs.train_config(cfg, "vjp"), spec, torch.Generator().manual_seed(0), dev)
    scene, _, fine_host, _ = cs.make_scene(dev, fine_level=7, wh=(8, 6), n_points=5000)
    fine = device_grid_from_host(fine_host, dev)
    _, fails = cs.graph_parity(cfg, state, scene, pool, None, -1, "warm-up", batch=512,
                               n_inner=4)
    pool.attach_surface(fine, fine_host.level)
    _, f2 = cs.graph_parity(cfg, state, scene, pool, fine, fine_host.level, "steady", batch=512,
                            n_inner=4)
    assert fails + f2 == []


# ------------------- K12: the two-level DDA; the served graph -------------------


def shell_hier(level, dev, n_points=1 << 20, seed=0):
    """A two-level grid of a shell of n_points points of a sphere of radius
    0.8 in the unit cube (tests/test_ops.py:168's pattern), as a host grid
    and on the card."""
    import numpy as np

    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv
    from neuralrecon_w_tpu_torch.ops.voxel_grid import VoxelGrid, _sort_coords

    v = np.random.default_rng(seed).standard_normal((n_points, 3))
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * 0.8
    res = 1 << level
    cells = np.clip(np.floor((v + 1.0) / 2.0 * res), 0, res - 1).astype(np.int64)
    host = VoxelGrid(level, np.zeros(3), 1.0, _sort_coords(cells, level))
    return host, rv.hier_grid_from_host(host, dev)


@pytest.mark.parametrize("first_only", [False, True])
@pytest.mark.parametrize("level", [9, 12])
def test_dda_hier_kernel_matches_plain_bit_for_bit(dev, level, first_only):
    """K12 against dda_traverse_hier_plain at levels 9 and 12, every output
    equal, over chip_smoke.level10_rays's four kinds (toward the shell, axis
    parallel, from occupied cells, misses)."""
    from chip_smoke import level10_rays
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    host, hg = shell_hier(level, dev)
    o, d = level10_rays(host, 8192, seed=level)
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    before = rv.dda_traverse_hier.launches
    trips = torch.empty(o.shape[0], dtype=torch.int32, device=dev)
    got = rv.dda_traverse_hier(hg, level, o, d, first_only, steps_out=trips)
    touched = (torch.zeros(hg.meta.shape[0], dtype=torch.int32, device=dev),
               torch.zeros_like(hg.fine))
    want = rv.dda_traverse_hier_plain(hg, level, o, d, first_only, touched=touched)
    torch.cuda.synchronize()
    assert rv.dda_traverse_hier.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[2].any()) and bool((~got[2]).any())
    # the plain version's meta reads (chip_smoke's bytes bound) are K12's trips
    assert int(touched[0].sum()) == int(trips.sum())


def test_dda_hier_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    _, hg = shell_hier(6, dev, n_points=4096)
    o = torch.zeros(8, 3, device=dev)
    with pytest.raises(ValueError):
        rv.dda_traverse_hier(hg, 7, o, o)  # a level-7 grid has more meta rows
    with pytest.raises(ValueError):
        rv.dda_traverse_hier(hg, 6, o.double(), o.double())
    with pytest.raises(ValueError):
        rv.dda_traverse_hier(hg._replace(fine=hg.fine.cpu()), 6, o, o)
    # fine off a 16-byte boundary: K12 reads a block's words as 16-byte loads
    shifted = torch.zeros(hg.fine.numel() + 1, dtype=torch.int32, device=dev)[1:]
    shifted.copy_(hg.fine)
    with pytest.raises(ValueError):
        rv.dda_traverse_hier(hg._replace(fine=shifted), 6, o, o)


@pytest.fixture(scope="module")
def hier_grids(dev):
    """(host grid, its two-level grid on the card) for K12's cases, built
    once per (level, kind):
    'sparse', blocks holding one or two cells each (rays cross occupied
    blocks without a hit); 'full', every block occupied (at level 12, the
    blocks of a 128^3-block sub-cube: all of them would be 8 GiB of fine
    words); 'shell', shell_hier's sphere of 2^20 points."""
    import numpy as np

    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv
    from neuralrecon_w_tpu_torch.ops.voxel_grid import VoxelGrid, _sort_coords

    cache = {}

    def get(level, kind):
        if (level, kind) not in cache:
            rng = np.random.default_rng(level)
            n_c = 1 << (level - 3)
            if kind == "shell":
                cache[level, kind] = shell_hier(level, dev)
                return cache[level, kind]
            if kind == "full":
                edge = min(n_c, 128)
                lo = (n_c - edge) // 2
                blocks = np.stack(np.meshgrid(*[np.arange(lo, lo + edge)] * 3, indexing="ij"),
                                  -1).reshape(-1, 1, 3)
                cells = blocks * 8 + rng.integers(0, 8, (len(blocks), 3, 3))
            else:
                blocks = rng.integers(0, n_c, (min(n_c ** 3 // 8 + 1, 200000), 1, 3))
                cells = blocks * 8 + rng.integers(0, 8, (len(blocks), 2, 3))
            host = VoxelGrid(level, np.zeros(3), 1.0, _sort_coords(cells.reshape(-1, 3), level))
            cache[level, kind] = host, rv.hier_grid_from_host(host, dev)
        return cache[level, kind]

    return get


def check_hier(dev, grids, o, d, first_only, max_steps=None):
    """K12 against dda_traverse_hier_plain on a (host grid, two-level grid)
    pair: every output and each ray's steps equal; the launch counted once.
    Returns the plain version's steps."""
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    host, hg = grids
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    r = o.shape[0]
    trips, steps = (torch.empty(r, dtype=torch.int32, device=dev) for _ in range(2))
    before = rv.dda_traverse_hier.launches
    got = rv.dda_traverse_hier(hg, host.level, o, d, first_only, max_steps, steps_out=trips)
    want = rv.dda_traverse_hier_plain(hg, host.level, o, d, first_only, max_steps,
                                      steps_out=steps)
    torch.cuda.synchronize()
    assert rv.dda_traverse_hier.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(trips, steps)
    return steps


def axis_rays(host, n, seed=0):
    """Rays along +z and -z through seeded occupied cells' (x, y) columns,
    and rays along z, x and y that cross a 32-block edge of a meta row
    (z-block 32 k) or a block edge in x / y, from outside the cube."""
    import numpy as np

    rng = np.random.default_rng(seed)
    res = 1 << host.level
    w = 2.0 / res
    cells = host.coords[rng.integers(0, len(host.coords), n)].astype(np.float64)
    centre = (cells + 0.5) * w - 1.0
    o, d = [], []
    for sign in (1.0, -1.0):  # along +-z through occupied columns
        oo = centre.copy()
        oo[:, 2] = -1.5 * sign
        o.append(oo)
        d.append(np.tile([0.0, 0.0, sign], (n, 1)))
    # oblique rays that cross z-block 32 k (a meta row's edge) mid-march
    n_c = res // 8
    k = rng.integers(1, max(n_c // 32, 2), n) * 32 % max(n_c, 1)
    z_edge = k * 8 * w - 1.0
    oo = centre.copy()
    oo[:, 2] = z_edge - 0.3
    dd = np.stack([rng.normal(0, 0.05, n), rng.normal(0, 0.05, n), np.ones(n)], 1)
    o.append(oo - dd * 2.0)
    d.append(dd)
    for axis in (0, 1):  # along x and along y
        oo = centre.copy()
        oo[:, axis] = -1.5
        dd = np.zeros((n, 3))
        dd[:, axis] = 1.0
        o.append(oo)
        d.append(dd)
    o, d = np.concatenate(o), np.concatenate(d)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("first_only", [False, True])
@pytest.mark.parametrize("kind", ["sparse", "full"])
@pytest.mark.parametrize("level", [3, 4, 9, 10, 12])
def test_dda_hier_kernel_on_sparse_and_full_grids(dev, hier_grids, level, kind, first_only):
    """K12 bit for bit (every output, each ray's steps) on grids whose
    occupied blocks hold one or two cells and on grids with every block
    occupied, over level10_rays's kinds (from outside, axis parallel, from
    occupied cells inside the cube, misses) and axis_rays (along +-z, across
    a meta row's 32-block edge, along x and y)."""
    import numpy as np

    from chip_smoke import level10_rays

    grids = hier_grids(level, kind)
    o1, d1 = level10_rays(grids[0], 4096, seed=level)
    o2, d2 = axis_rays(grids[0], 256, seed=level)
    steps = check_hier(dev, grids, np.concatenate([o1, o2]), np.concatenate([d1, d2]),
                       first_only)
    assert int(steps.max()) > 1


@pytest.mark.parametrize("max_steps", [1, 2, 7, 8, 9, 33])
@pytest.mark.parametrize("level", [4, 12])
def test_dda_hier_kernel_max_steps_cuts(dev, hier_grids, level, max_steps):
    """K12 cut after max_steps steps (1, 2, 7, 8, 9, 33: after the first
    steps, around eight and past a meta row's 32 blocks) against the plain
    version with the same cut, both first_only modes: each ray's march is
    the uncut one's, cut."""
    from chip_smoke import level10_rays

    grids = hier_grids(level, "shell" if level == 12 else "sparse")
    o, d = level10_rays(grids[0], 2048, seed=max_steps)
    for first in (False, True):
        full = check_hier(dev, grids, o, d, first)
        cut = check_hier(dev, grids, o, d, first, max_steps)
        assert torch.equal(cut, full.clamp(max=max_steps))


@pytest.mark.parametrize("first_only", [False, True])
@pytest.mark.parametrize("n_rays", [1, 3, 8189, 262144])
def test_dda_hier_kernel_ragged_ray_counts(dev, hier_grids, n_rays, first_only):
    """K12 at ragged ray counts on the level-12 shell: one block of a warp
    (1, 3), blocks of 32 to 128 threads (8189), and the filter's call of
    262,144 rays whose last quarter are its padding rays (origins at 4.0,
    along +z: sure misses)."""
    import numpy as np

    from chip_smoke import level10_rays

    grids = hier_grids(12, "shell")
    real = n_rays if n_rays < 262144 else 3 * n_rays // 4
    o, d = level10_rays(grids[0], max(real, 4), seed=n_rays)
    o, d = o[:real], d[:real]
    if real < n_rays:  # render_hit_codes_multi's padding
        o = np.concatenate([o, np.full((n_rays - real, 3), 4.0, np.float32)])
        d = np.concatenate([d, np.tile(np.float32([0.0, 0.0, 1.0]), (n_rays - real, 1))])
    steps = check_hier(dev, grids, np.ascontiguousarray(o), np.ascontiguousarray(d),
                       first_only)
    if real < n_rays:
        assert int(steps[real:].abs().sum()) == 0


@pytest.mark.parametrize("level", [4, 9, 10, 11, 12])
def test_hier_mask_kernel_matches_plain(dev, hier_grids, level):
    """K12's pre-pass (K10's over meta's coarse words) against its plain
    version, on a sparse grid and on the shell: at every level the
    pre-pass takes (10 up, whether or not K12 marches through the mask
    there) and below it, where the mask is meta's coarse words."""
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    for kind in ("sparse", "shell"):
        hg = hier_grids(level, kind)[1]
        got = rv.hier_mask(hg, level)
        torch.cuda.synchronize()
        want = rv.coarse_words_plain(hg.meta[:, 0].contiguous(), level - 3,
                                     rv.mask_shift(level - 3))
        assert torch.equal(got, want)
        bits = (got.to(torch.int64)[:, None] >> torch.arange(32, device=dev)) & 1
        assert 0 < int(bits.sum()) < bits.numel()  # mask blocks empty and occupied both


def test_captured_served_chunk_matches_eager(dev):
    """make_scan_render_fn's graph against the eager chunk loop (chip_smoke's
    serving_graph_phase at a narrow width, both serving phases): every
    frame equal bit for bit, and a new fine grid copied into the graph's."""
    import chip_smoke as cs
    import numpy as np
    from neuralrecon_w_tpu_torch.config import (field_config_from_cfg, load_cfg,
                                                render_config_from_cfg)
    from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
    from neuralrecon_w_tpu_torch.models.neuconw import init_field
    from neuralrecon_w_tpu_torch.training.step import make_render_fn, make_scan_render_fn
    from neuralrecon_w_tpu_torch.training.validation import render_image

    cfg = load_cfg(CONFIG)
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
    n.SDF_CONFIG.skip_in = (2,)
    n.COLOR_CONFIG.d_feature, n.N_VOCAB = 64, 16
    fc = field_config_from_cfg(cfg)
    model = init_field(fc, torch.Generator().manual_seed(0), dev).requires_grad_(False)
    wh = (48, 36)
    scene, sfm_host, fine_host, frames = cs.make_scene(dev, fine_level=7, wh=wh, n_points=5000)
    sfm, fine = device_grid_from_host(sfm_host, dev), device_grid_from_host(fine_host, dev)
    for level, fg in ((-1, None), (fine_host.level, fine)):
        rc = render_config_from_cfg(cfg, sfm_level=sfm_host.level, fine_level=level,
                                    nerf_far_override=True)
        _, launches, fails = cs.serving_graph_phase(model, fc, rc, scene, frames, fg, sfm, "p",
                                                    wh=wh)
        assert fails == [] and launches["up_sample"] > 0
    # a refreshed grid of the same level: copied into the captured one
    rc = render_config_from_cfg(cfg, sfm_level=sfm_host.level, fine_level=fine_host.level,
                                nerf_far_override=True)
    run = make_scan_render_fn(fc, rc, 512)
    args = (frames[0], np.zeros(len(frames[0]), np.int64), np.zeros(len(frames[0]), np.int64),
            wh, 512)
    render_image(None, model, scene, *args, fine, sfm, scan_render=run)
    thin = type(fine_host)(fine_host.level, fine_host.origin, fine_host.scale,
                           fine_host.coords[::2])
    fine2 = device_grid_from_host(thin, dev)
    got = render_image(None, model, scene, *args, fine2, sfm, scan_render=run)
    want = render_image(make_render_fn(fc, rc), model, scene, *args, fine2, sfm)
    assert run.captures == 1 and torch.equal(fine.occ, fine2.occ)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# ------------- the kernel modes' autograd Functions in a CUDA graph -------------

# a replay after the weights moved in place against an eager call on the
# new weights: the forward kernels (K3, K6, K8) have no atomics, so their
# outputs agree to the bit; K5 sums dW with float atomics, so the gradients
# agree to f32 summation order: REPLAY_GRAD_REL, rel-L2 per tensor
REPLAY_GRAD_REL = 1e-5


def replay_after_update(fn, params, n_out, seed):
    """fn() -> (forward outputs..., gradients...), the first n_out the
    forward's, every one detached (an output that kept its autograd graph
    alive would keep its leaves' gradient nodes on the stream that made
    them, which a capture on another stream cannot wait on). Runs it once
    eagerly on a side stream, once eagerly as the
    reference on the capture-time weights, captures it in a CUDAGraph, moves
    every parameter in place (seeded noise), replays, and runs it eagerly
    on the new weights. Returns (before, replayed, eager, launches at
    capture by counter)."""
    from neuralrecon_w_tpu_torch.ops import read_launches

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    before = [t.clone() for t in fn()]
    g = torch.cuda.CUDAGraph()
    counts = read_launches()
    with torch.cuda.graph(g):
        static = fn()
    after = read_launches()
    gen = torch.Generator(device=params[0].device).manual_seed(seed)
    with torch.no_grad():
        for p in params:
            p.add_(torch.randn(p.shape, generator=gen, device=p.device)
                   * (0.02 * float(p.abs().mean()) + 1e-3))
    g.replay()
    got = [t.clone() for t in static]
    want = fn()
    torch.cuda.synchronize()
    assert len(got) == len(want) == len(before) and n_out < len(got)
    return before, got, want, {k: after[k] - counts[k] for k in after if after[k] - counts[k]}


def check_replay(before, got, want, n_out):
    """The replay equals the eager call on the new weights (forward to the
    bit, gradients within REPLAY_GRAD_REL); the forward outputs moved with
    the weights, and the gradients as a whole moved far more than that
    tolerance (some, such as an output bias's, do not depend on them), so
    a pack frozen at capture would fail."""
    for i, (b, k, w) in enumerate(zip(before, got, want)):
        assert bool(torch.isfinite(k).all()), i
        if i < n_out:
            assert not torch.equal(k, b), f"output {i} did not follow the weights"
            assert torch.equal(k, w), i
        else:
            assert rel_l2(k, w) <= REPLAY_GRAD_REL, (i, rel_l2(k, w))
    flat = lambda ts: torch.cat([t.reshape(-1) for t in ts[n_out:]])  # noqa: E731
    assert rel_l2(flat(before), flat(want)) > 100 * REPLAY_GRAD_REL


@pytest.mark.parametrize("fwd_impl", ["kernel", "plain"])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_sdf_value_grad_replays_follow_weights(dev, flagship, act, fwd_impl):
    """_SDFValueGrad (K3 forward, or the plain one of 'pallas_hybrid', and
    K4 + K5 backward) captured once, forward and backward: after the SDF
    net's parameters move in place a replay equals an eager call on the new
    weights (the pack is rebuilt inside the graph on every replay)."""
    from neuralrecon_w_tpu_torch.ops.sdf_field_vjp import sdf_value_feat_grad_kernel

    fc, net = flagship
    net = copy.deepcopy(net).requires_grad_(True)
    params = list(net.parameters())
    _, _, x, c_out, c_grad = vjp_inputs(net, 8192, 31)
    x = x.requires_grad_(True)

    def fn():
        s, f, g = sdf_value_feat_grad_kernel(net, fc.sdf, x, act, fwd_impl=fwd_impl)
        loss = torch.sum(s * c_out[:, 0]) + torch.sum(f * c_out[:, 1:]) + torch.sum(g * c_grad)
        return (s.detach(), f.detach(), g.detach(), *torch.autograd.grad(loss, params + [x]))

    before, got, want, launched = replay_after_update(fn, params, 3, 32)
    check_replay(before, got, want, 3)
    assert launched["sdf_vjp_bwd"] == 1 and launched["dw_reduce"] == net.n_layers
    assert launched.get("sdf_vjp_fwd", 0) == (1 if fwd_impl == "kernel" else 0)


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_field_train_replays_follow_weights(dev, field, act):
    """_FieldTrain (K6 forward, K7 + K5 backward) captured once through
    field_forward's 'pallas_field' mode, per-ray dirs and a: after every SDF
    and colour parameter moves in place a replay equals an eager call."""
    from neuralrecon_w_tpu_torch.models.neuconw import field_forward

    fc, model = field
    fc = fc._replace(act_dtype=act, grad_mode="pallas_field")
    model = copy.deepcopy(model).requires_grad_(True)
    params = [p for k, p in model.named_parameters() if "_net." in k]
    n_rays, n_samples = 512, 16
    pts, dirs, a = field_inputs(fc, n_rays * n_samples, dev, 33)
    xs = [t.requires_grad_(True) for t in (pts, dirs[:n_rays].clone(), a[:n_rays].clone())]
    gen = torch.Generator().manual_seed(34)
    c = [torch.randn(n_rays * n_samples, k, generator=gen).to(dev).squeeze(1) for k in (3, 1, 3)]

    def fn():
        rgb, _, sdf, grad, _ = field_forward(model, fc, *xs, n_samples, create_graph=True)
        loss = torch.sum(rgb * c[0]) + torch.sum(sdf * c[1]) + torch.sum(grad * c[2])
        return (rgb.detach(), sdf.detach(), grad.detach(),
                *torch.autograd.grad(loss, params + xs))

    before, got, want, launched = replay_after_update(fn, params, 3, 35)
    check_replay(before, got, want, 3)
    assert launched["field_fwd"] == 1 and launched["field_bwd"] == 1
    assert launched["dw_reduce"] > 0


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_nerf_bg_replays_follow_weights(dev, act):
    """_NerfBG (K8 forward, K9 + K5 backward) captured once with the
    appearance head: after every layer moves in place a replay equals an
    eager call on the new weights."""
    from neuralrecon_w_tpu_torch.models.nerf_bg import NeRF, init_nerf_bg_
    from neuralrecon_w_tpu_torch.ops import nerf_bg_fused as bgf

    net = NeRF(True, 48, dev)
    init_nerf_bg_(net, torch.Generator().manual_seed(36))
    layers = bgf.bg_layers(net, True)
    params = [p for m in layers for p in (m.weight, m.bias)]
    _, _, x, (c_den, c_rgb) = bg_case(True, 8192, dev, 37)
    xs = [t.requires_grad_(True) for t in x]

    def fn():
        den, rgb = bgf.nerf_bg_kernel(net, True, *xs, act=act)
        loss = torch.sum(den * c_den) + torch.sum(rgb * c_rgb)
        return (den.detach(), rgb.detach(), *torch.autograd.grad(loss, params + xs))

    before, got, want, launched = replay_after_update(fn, params, 2, 38)
    check_replay(before, got, want, 2)
    assert launched["nerf_bg_fwd"] == 1 and launched["nerf_bg_bwd"] == 1
    assert launched["dw_reduce"] == len(layers)
