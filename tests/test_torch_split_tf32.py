"""PyTorch port, K15 (``ops/split_tf32``, ``csrc/split_tf32_gemm.cu``): the
split-TF32 product that the field's float32 linears run on a card. On the
CPU: the plain version's error against float64 beside a float32 and a
TF32 product's, its autograd Function's derivatives in float64, and the
route ``models/layers._product`` takes. Marked ``cuda``: the kernel against
its plain version and float64 at the float32 cells' shapes, under CUDA-graph
capture, and its split-K weight gradient run twice (on a machine without
JAX run with ``--noconftest``)."""

import os
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg  # noqa: E402
from neuralrecon_w_tpu_torch.models import color, layers, nerf_bg, sdf  # noqa: E402
from neuralrecon_w_tpu_torch.ops import split_tf32 as st  # noqa: E402
from neuralrecon_w_tpu_torch.models.neuconw import init_field  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CONFIGS = {"bg_op": "config/train_brandenburg_gate_tpu.yaml",
           "bg_ref": "config/train_brandenburg_gate.yaml"}
RAYS, SAMPLES = 6, 4
ERR_RATIO = 8.0  # the split's error over a float32 product's: ~3 bits of 24
TF32_MARGIN = 100.0  # a TF32 product's error over the split's, at least


def operands(form, m, n, k, seed=0, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(*((m, k) if form != "tn" else (k, m)), generator=g, dtype=torch.float64)
    b = torch.randn(*((n, k) if form == "nt" else (k, n)), generator=g, dtype=torch.float64)
    return a.to(dtype).to(device), (b / k ** 0.5).to(dtype).to(device)


def errors(c, exact):
    e = (c.double() - exact).abs().flatten()
    return float(e.max()), float(e.median())


@pytest.mark.parametrize("n", [8, 260, 512])
@pytest.mark.parametrize("k", [132, 256, 512])
def test_split_product_error_against_float64(k, n):
    """At the cells' widths the split's error against float64, max and
    median, is within ERR_RATIO of a float32 product's and TF32_MARGIN
    below one TF32-rounded product's (the control that fails the gates)."""
    torch.set_num_threads(1)
    a, b = operands("nt", 256, n, k)
    exact = a.double() @ b.double().t()
    split = errors(st.split_tf32_gemm_plain(a, b, "nt"), exact)
    f32 = errors(a @ b.t(), exact)
    tf32 = errors(st.tf32_round(a) @ st.tf32_round(b).t(), exact)
    for i in range(2):
        assert split[i] <= ERR_RATIO * f32[i], (split, f32)
        assert split[i] * TF32_MARGIN <= tf32[i], (split, tf32)


def test_tf32_round_to_nearest_ties_away():
    """``tf32_round`` is ``cvt.rna.tf32.f32``: 10 mantissa bits kept, the
    nearest, a tie away from zero; the two halves carry x within 2^-22."""
    one, ulp = 1.0, 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 3 * ulp / 2, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 0.0, -0.0])
    assert torch.equal(st.tf32_round(x), want)
    r = torch.randn(100_000, generator=torch.Generator().manual_seed(3)) * 1e3
    hi, lo = st.tf32_split(r)
    for h in (hi, lo):
        assert not (h.view(torch.int32) & 0x1FFF).any()
    assert ((r.double() - hi.double() - lo.double()).abs() <= 2.0 ** -22 * r.double().abs()).all()


@pytest.mark.parametrize("form", ["nt", "nn", "tn"])
def test_split_product_function_derivatives(form):
    """The autograd Function's first and second derivatives (gradcheck,
    gradgradcheck) in float64, where the plain version does not round, each
    form's gradients themselves products of the three forms."""
    a, b = operands(form, 5, 3, 4, seed=1, dtype=torch.float64)
    a.requires_grad_(True)
    b.requires_grad_(True)
    args = (a, b)
    if form == "nt":
        args += (torch.randn(3, dtype=torch.float64, requires_grad=True),)

    def fn(a, b, bias=None):
        return st.SplitTF32Product.apply(a, b, bias, form)

    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


def test_split_linear_derivatives_match_f_linear():
    """The linear's output, first and second derivatives equal
    ``F.linear``'s in float64."""
    g = torch.Generator().manual_seed(2)
    x0 = torch.randn(7, 6, generator=g, dtype=torch.float64)
    w0 = torch.randn(4, 6, generator=g, dtype=torch.float64)
    b0 = torch.randn(4, generator=g, dtype=torch.float64)
    outs = []
    for fn in (st.split_tf32_linear, F.linear):
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        y = fn(x, w, b)
        (gx,) = torch.autograd.grad(torch.sin(y).sum(), x, create_graph=True)
        gx.square().sum().backward()
        outs.append((y.detach(), gx.detach(), x.grad, w.grad, b.grad))
    for got, want in zip(*outs):
        assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_split_linear_under_jvp_and_vmap_matches_f_linear():
    """Under ``torch.func``'s ``vmap`` over ``jvp`` (the 'fwd' SDF mode's
    transform) with a loss on the tangents taken back by reverse mode, two
    linears through the Function equal ``F.linear``'s in float64: outputs,
    tangents and every parameter's gradient."""
    from torch.func import jvp, vmap

    g = torch.Generator().manual_seed(3)
    x = torch.randn(7, 6, generator=g, dtype=torch.float64)
    params = [torch.randn(*shape, generator=g, dtype=torch.float64).requires_grad_(True)
              for shape in ((5, 6), (5,), (4, 5))]
    tangents = torch.eye(6, dtype=torch.float64)[:3, None, :].expand(3, 7, 6)
    outs = []
    for lin in (st.split_tf32_linear, F.linear):
        def f(pts):
            return lin(torch.tanh(lin(pts, params[0], params[1])), params[2])

        y, dy = vmap(lambda t: jvp(f, (x,), (t,)), out_dims=(None, 0))(tangents)
        grads = torch.autograd.grad(y.square().sum() + dy.square().sum(), params)
        outs.append((y, dy) + grads)
    for got, want in zip(*outs):
        assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_tile_width_and_slices_cover_the_product():
    """Every width gets a tile of the kernel's instances; a weight
    gradient's slices are each non-empty, cover its rows, and give the SMs
    at most a block each."""
    for n in (1, 4, 8, 40, 84, 132, 256, 260, 476, 512, 1000):
        assert st.tile_width(n) in st.WIDTHS
    assert st.tile_width(512) == 128 and st.tile_width(4) == 8 and st.tile_width(260) == 136
    assert st.tile_cost(512, 4) < st.tile_cost(4, 512)  # the sdf row's dW runs transposed
    for tiles in (1, 2, 6, 16, 64, 200):
        for k in (1, 32, 100, 4096, 245_760, 1_228_800):
            slices, per = st.slices_for(tiles, k)
            stages = -(-k // st.BK)
            assert (slices - 1) * per < stages <= slices * per
            assert slices == 1 or tiles * slices <= st.SMS


def routed_field_step(config, act, monkeypatch=None):
    """The bg_op / bg_ref field's forward, SDF input gradient, colour and
    background nets and double backward on the CPU, with the products'
    counters read around it; ``monkeypatch`` takes the route as on a card."""
    if monkeypatch is not None:
        route = layers._split_route
        monkeypatch.setattr(layers, "_split_route", lambda x: route(
            SimpleNamespace(dtype=x.dtype, is_cuda=True)))
    fc = field_config_from_cfg(load_cfg(os.path.join(ROOT, CONFIGS[config])))
    model = init_field(fc, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=gen))
    n = RAYS * SAMPLES
    pts = (torch.randn(n, 3, generator=gen) * 0.4).to(act)
    d = F.normalize(torch.randn(RAYS, 3, generator=gen), dim=-1).to(act)
    a = torch.randn(RAYS, 48, generator=gen).to(act)
    pts4 = torch.cat([pts, (torch.rand(n, 1, generator=gen) * 0.9 + 0.1).to(act)], -1)
    before = (layers.linear.aligned, layers.linear.fallback, layers.linear.split_tf32)
    x = pts.requires_grad_(True)
    s, feat = sdf.apply_sdf_split(model.neuconw.sdf_net, fc.sdf_cfg, x, act)
    (g,) = torch.autograd.grad(s, x, torch.ones_like(s), create_graph=True)
    rgb = color.apply_color(model.neuconw.color_net, fc.color_cfg, fc.encode_a, x, g, d, feat, a,
                            act_dtype=act, n_samples=SAMPLES)
    density, rgb_bg = nerf_bg.apply_nerf_bg(model.nerf, fc.encode_a_bg, pts4, d, a,
                                            act_dtype=act, n_samples=SAMPLES)
    loss = (rgb.float().square().sum() + ((g.float().norm(dim=-1) - 1) ** 2).sum()
            + s.float().sum() + density.float().sum() + rgb_bg.float().sum())
    loss.backward()
    counts = tuple(after - b for after, b in zip(
        (layers.linear.aligned, layers.linear.fallback, layers.linear.split_tf32), before))
    grads = [p.grad.clone() for p in model.parameters() if p.grad is not None]
    return counts, [t.detach().float() for t in (s, g, rgb, density, rgb_bg)], grads


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_field_products_route(config, dtype, monkeypatch):
    """Taken as on a card, every float32 product of the field's forward,
    input gradient and double backward goes through K15's Function (plain
    on the CPU) and ``linear.split_tf32`` counts each, as ``linear.aligned``
    does, which counts as on the library's route; a bf16 product never
    reaches it. The routed outputs and gradients equal the library's to
    float32 rounding."""
    act = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    (aligned, fallback, split), outs, grads = routed_field_step(config, act, monkeypatch)
    issued = 10 + 9 + 16  # one product a linear (two in the SDF's last layer, colour, background)
    assert (aligned, fallback) == (issued, 0)
    assert split == (issued if act == torch.float32 else 0)
    monkeypatch.undo()
    (aligned0, fallback0, split0), outs0, grads0 = routed_field_step(config, act)
    assert (aligned0, fallback0, split0) == (issued, 0, 0)
    if act == torch.bfloat16:
        return
    for got, want in zip(outs + grads, outs0 + grads0):
        scale = float(want.abs().max()) + 1e-30
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_fwd_mode_products_route(monkeypatch):
    """The 'fwd' SDF mode (``vmap`` over ``jvp``) at bg_ref's widths, taken
    as on a card: its products go through the Function, and its sdf,
    feature and gradient equal the library route's to float32 rounding."""
    fc = field_config_from_cfg(load_cfg(os.path.join(ROOT, CONFIGS["bg_ref"])))
    net = init_field(fc, torch.Generator().manual_seed(0), device="cpu").neuconw.sdf_net
    x = torch.randn(RAYS * SAMPLES, 3, generator=torch.Generator().manual_seed(4)) * 0.4
    want = sdf.sdf_value_feat_grad_fwdmode(net, fc.sdf_cfg, x)
    route = layers._split_route
    monkeypatch.setattr(layers, "_split_route", lambda t: route(
        SimpleNamespace(dtype=t.dtype, is_cuda=True)))
    before = layers.linear.split_tf32
    got = sdf.sdf_value_feat_grad_fwdmode(net, fc.sdf_cfg, x)
    assert layers.linear.split_tf32 - before == 10
    for a, b in zip(got, want):
        a, b = a.detach(), b.detach()
        assert float((a - b).abs().max()) <= 1e-5 * (float(b.abs().max()) + 1e-30)


def test_split_route_reads_dtype_and_device():
    """The route is the operand's: float32 on a card; bf16 on a card and
    anything on the CPU take ``F.linear``."""
    assert layers._split_route(SimpleNamespace(dtype=torch.float32, is_cuda=True))
    assert not layers._split_route(SimpleNamespace(dtype=torch.bfloat16, is_cuda=True))
    assert not layers._split_route(SimpleNamespace(dtype=torch.float32, is_cuda=False))
    assert not layers._split_route(torch.zeros(2, 2))


def test_chip_smoke_split_phase_rehearsal():
    """``chip_smoke.split_tf32_phase`` on the CPU at a small shape (the plain
    version in K15's place): each product form's error against float64 is
    read and held within its ratio to a float32 product's."""
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke

    res, fails = chip_smoke.split_tf32_phase({"tiny": ((300, 132, 8),)}, dev="cpu",
                                             time_it=False)
    assert fails == [] and len(res) == 3
    assert {r["form"] for r in res.values()} == {"nt", "nn", "tn"}
    assert all(r["err_ratio"] <= chip_smoke.SPLIT_ERR_RATIO for r in res.values())


# ------------------------------- on a card -------------------------------

# (rows, k, n) of a linear y = x w^T at the float32 cells' widths: bg_ref's
# SDF hidden layer, its last layer's feature rows, the sdf row, the hash
# MLP's first (131 -> 256, padded to 132) and second (256 -> 257) layers,
# at train.ref's 245,760 points a step
CARD_SHAPES = [(245_760, 512, 512), (245_760, 512, 260), (245_760, 512, 4),
               (245_760, 132, 256), (245_760, 256, 260), (8192, 132, 8)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K15 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def form_operands(x, w, dy, form):
    return {"nt": (x, w), "nn": (dy, w), "tn": (dy, x)}[form]


def exact_product(a, b, form):
    return st._mm(a.double(), b.double(), form)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["nt", "nn", "tn"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k15_matches_plain_and_float64(dev, shape, form):
    """K15 at the cells' forward ('nt'), input-gradient ('nn') and weight-
    gradient ('tn', split-K over the 245,760 points) shapes: its error
    against float64 within ERR_RATIO of a float32 product's, max and
    median, and within the same of its plain version."""
    rows, k, n = shape
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(rows, k, device=dev, generator=g)
    w = torch.randn(n, k, device=dev, generator=g) / k ** 0.5
    dy = torch.randn(rows, n, device=dev, generator=g)
    a, b = form_operands(x, w, dy, form)
    exact = exact_product(a, b, form)
    got = st.split_tf32_gemm(a, b, form)
    err = errors(got, exact)
    f32 = errors(st._mm(a, b, form), exact)
    plain = st.split_tf32_gemm_plain(a, b, form)
    gap = float((got - plain).abs().max())
    for i in range(2):
        assert err[i] <= ERR_RATIO * f32[i], (err, f32)
    assert gap <= ERR_RATIO * f32[0], (gap, f32)


@pytest.mark.cuda
def test_k15_bias_in_the_epilogue(dev):
    """'nt' with a bias: the product plus the bias, a ragged k and rows."""
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(1000, 132, device=dev, generator=g)
    w = torch.randn(260, 132, device=dev, generator=g) / 132 ** 0.5
    bias = torch.randn(260, device=dev, generator=g)
    exact = exact_product(x, w, "nt") + bias.double()
    err = errors(st.split_tf32_gemm(x, w, "nt", bias), exact)
    f32 = errors(F.linear(x, w, bias), exact)
    assert err[0] <= ERR_RATIO * f32[0]


@pytest.mark.cuda
def test_k15_captured_replay_equals_eager(dev):
    """The three forms captured in one CUDA graph, the operands moved in
    place, the replay equal to eager launches bit for bit."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(20_000, 256, device=dev, generator=g)
    w = torch.randn(260, 256, device=dev, generator=g)
    dy = torch.randn(20_000, 260, device=dev, generator=g)

    def run():
        return [st.split_tf32_gemm(*form_operands(x, w, dy, f), f) for f in ("nt", "nn", "tn")]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for t in (x, w, dy):
        t.mul_(0.5).add_(0.25)
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(outs, run()):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_k15_weight_gradient_repeats_bit_for_bit(dev):
    """The split-K weight gradient sums its slices in a fixed order: two
    runs of one dW are equal."""
    g = torch.Generator(device=dev).manual_seed(10)
    dy = torch.randn(245_760, 512, device=dev, generator=g)
    x = torch.randn(245_760, 512, device=dev, generator=g)
    assert torch.equal(st.split_tf32_gemm(dy, x, "tn"), st.split_tf32_gemm(dy, x, "tn"))


@pytest.mark.cuda
def test_k15_function_derivatives_on_the_card(dev):
    """The linear's first and second derivatives on the card (K15 in every
    product) against float64 ``F.linear``'s, within float32's reach."""
    g = torch.Generator().manual_seed(11)
    x0 = torch.randn(4096, 132, generator=g, dtype=torch.float64)
    w0 = torch.randn(260, 132, generator=g, dtype=torch.float64) / 132 ** 0.5
    b0 = torch.randn(260, generator=g, dtype=torch.float64)
    outs = []
    for fn, dt, d in ((st.split_tf32_linear, torch.float32, dev), (F.linear, torch.float64, "cpu")):
        x, w, b = (t.to(dt).to(d).requires_grad_(True) for t in (x0, w0, b0))
        launches = st.split_tf32_gemm.launches
        y = fn(x, w, b)
        (gx,) = torch.autograd.grad(torch.sin(y).sum(), x, create_graph=True)
        gx.square().sum().backward()
        outs.append([t.detach().double().cpu() for t in (y, gx, x.grad, w.grad, b.grad)])
        if dt == torch.float32:
            assert st.split_tf32_gemm.launches - launches >= 5
    for got, want in zip(*outs):
        assert float((got - want).abs().max()) <= 1e-4 * (float(want.abs().max()) + 1.0)


@pytest.mark.cuda
def test_k15_under_jvp_and_vmap_on_the_card(dev):
    """The 'fwd' mode's transform on the card (K15 in the primal, tangent
    and reverse products) against float64 ``F.linear`` on the CPU."""
    from torch.func import jvp, vmap

    g = torch.Generator().manual_seed(12)
    x0 = torch.randn(4096, 40, generator=g, dtype=torch.float64)
    p0 = [torch.randn(260, 40, generator=g, dtype=torch.float64) / 40 ** 0.5,
          torch.randn(260, generator=g, dtype=torch.float64),
          torch.randn(8, 260, generator=g, dtype=torch.float64) / 260 ** 0.5]
    outs = []
    for lin, dt, d in ((st.split_tf32_linear, torch.float32, dev), (F.linear, torch.float64, "cpu")):
        x = x0.to(dt).to(d)
        params = [t.to(dt).to(d).requires_grad_(True) for t in p0]
        tangents = torch.eye(40, dtype=dt, device=d)[:3, None, :].expand(3, *x.shape)

        def f(pts):
            return lin(torch.tanh(lin(pts, params[0], params[1])), params[2])

        y, dy = vmap(lambda t: jvp(f, (x,), (t,)), out_dims=(None, 0))(tangents)
        grads = torch.autograd.grad(y.square().sum() + dy.square().sum(), params)
        outs.append([t.detach().double().cpu() for t in (y, dy) + grads])
    for got, want in zip(*outs):
        assert float((got - want).abs().max()) <= 1e-4 * (float(want.abs().max()) + 1.0)
