"""PyTorch port, the field's products (``models/layers.linear``): one product
a linear over one operand whose base and leading dimension are multiples
of 16 bytes, with the bias in the product's epilogue, at the published
widths of the brandenburg_gate configurations (bg_op: the port's operating
point in bf16; bg_ref: the reference's budget in f32)."""

import os

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg  # noqa: E402
from neuralrecon_w_tpu_torch.models import color, layers, nerf_bg, sdf  # noqa: E402
from neuralrecon_w_tpu_torch.models.neuconw import NeuconWField  # noqa: E402
from neuralrecon_w_tpu_torch.models.neuconw import init_field  # noqa: E402
from neuralrecon_w_tpu_torch.training.checkpoint import with_dead_entries  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CONFIGS = {"bg_op": "config/train_brandenburg_gate_tpu.yaml",
           "bg_ref": "config/train_brandenburg_gate.yaml"}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
PRODUCT_OPS = {"mm", "addmm", "bmm", "baddbmm"}
RAYS, SAMPLES = 6, 4  # 24 sample rows


def field(config, seed=0, noise=0.0):
    """A bg_op / bg_ref field on the CPU; ``noise`` perturbs every
    parameter, so that no column the init zeroes hides a path."""
    fc = field_config_from_cfg(load_cfg(os.path.join(ROOT, CONFIGS[config])))
    model = init_field(fc, torch.Generator().manual_seed(seed), device="cpu")
    if noise:
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(noise * torch.randn(p.shape, generator=gen))
    return fc, model


def inputs(seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    n = RAYS * SAMPLES
    pts = (torch.randn(n, 3, generator=gen) * 0.4).to(dtype)
    d = torch.randn(RAYS, 3, generator=gen)
    d = (d / d.norm(dim=-1, keepdim=True)).to(dtype)
    a = torch.randn(RAYS, 48, generator=gen).to(dtype)
    pts4 = torch.cat([pts, torch.rand(n, 1, generator=gen).to(dtype) * 0.9 + 0.1], -1)
    return pts, d, a, pts4


def n_linears(net):
    return sum(isinstance(m, (torch.nn.Linear, layers.WNLinear)) for m in net.modules())


def aligned(t):
    """The base and, for a matrix with no dimension of 1, the leading
    stride are multiples of 16 bytes."""
    size = t.element_size()
    if t.storage_offset() * size % 16:
        return False
    if t.dim() < 2 or 1 in t.shape[-2:]:
        return True
    if 1 not in (t.stride(-1), t.stride(-2)):
        return False
    ld = t.stride(-2) if t.stride(-1) == 1 else t.stride(-1)
    return ld * size % 16 == 0


class Products(TorchDispatchMode):
    """Every matrix product dispatched inside the block, with its tensor
    operands and its output."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in PRODUCT_OPS:
            self.calls.append((func.overloadpacket.__name__,
                               [a for a in args if isinstance(a, torch.Tensor)], out))
        return out

    def misaligned(self):
        return [(name, [(tuple(t.shape), t.stride(), t.storage_offset()) for t in ins + [out]])
                for name, ins, out in self.calls if not all(aligned(t) for t in ins + [out])]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_field_products_aligned_one_per_linear(config, dtype):
    """The forward issues one product a linear (two where a per-ray block
    is taken once a ray or the SDF's last layer splits its sdf row from its
    feature rows), and every product of the forward, the SDF's input
    gradient and the double backward has aligned operands; the counter
    reads no fallback."""
    act = DTYPES[dtype]
    fc, model = field(config)
    pts, d, a, pts4 = inputs(1)
    sdf_net, color_net = model.neuconw.sdf_net, model.neuconw.color_net
    before = (layers.linear.aligned, layers.linear.fallback)

    x = pts.requires_grad_(True)
    with Products() as fwd:
        s, feat = sdf.apply_sdf_split(sdf_net, fc.sdf_cfg, x, act)
    # the last layer: the sdf row's product and the feature rows'
    assert len(fwd.calls) == n_linears(sdf_net) + 1 == 10
    with Products() as grad_pass:
        (g,) = torch.autograd.grad(s, x, torch.ones_like(s), create_graph=True)
    with Products() as col:
        rgb = color.apply_color(color_net, fc.color_cfg, fc.encode_a, x, g, d, feat, a,
                                act_dtype=act, n_samples=SAMPLES)
    assert len(col.calls) == n_linears(color_net) + 1 == 9
    with Products() as bg:
        density, rgb_bg = nerf_bg.apply_nerf_bg(model.nerf, fc.encode_a_bg, pts4, d, a,
                                                act_dtype=act, n_samples=SAMPLES)
    assert len(bg.calls) == n_linears(model.nerf) + 1 == 16
    with Products() as sweep:
        s_only = sdf.sdf_value(sdf_net, fc.sdf_cfg, pts.detach(), act)
    assert len(sweep.calls) == 9 and s_only.shape == (RAYS * SAMPLES,)
    with Products() as per_sample:
        color.apply_color(color_net, fc.color_cfg, fc.encode_a, x, g,
                          layers.per_sample(d, SAMPLES), feat, layers.per_sample(a, SAMPLES),
                          act_dtype=act)
    assert len(per_sample.calls) == n_linears(color_net)

    loss = (rgb.float().square().sum() + ((g.float().norm(dim=-1) - 1) ** 2).sum()
            + s.float().sum() + density.float().sum() + rgb_bg.float().sum())
    with Products() as bwd:
        loss.backward()
    assert grad_pass.calls and bwd.calls
    for rec in (fwd, grad_pass, col, bg, sweep, per_sample, bwd):
        assert rec.misaligned() == []
    issued = 10 + 9 + 16 + 9 + 8
    assert (layers.linear.aligned - before[0], layers.linear.fallback - before[1]) == (issued, 0)


def partial_products(weight, bias, parts):
    """The formula the one product replaced: a product per input block
    over the weight's column slice, the partial sums and the bias added
    after them."""
    acc, off = bias, 0
    for x in parts:
        k = x.shape[-1]
        y = x @ weight[:, off:off + k].t()
        acc = y if acc is None else acc + y
        off += k
    assert off == weight.shape[1]
    return acc


def reference_linear(layer, x, dtype=None, *, scale=None, n_samples=None, outs=None,
                     widths=None, padded=False, norm_first=False):
    """``layers.linear`` as row-block partial products over the blocks'
    own columns (their padding dropped first), its output unpadded."""
    parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    w, b = layers.weight_bias(layer, dtype, norm_first)
    if widths is None and len(parts) == 1:
        widths = (w.shape[1],)
    if widths is not None:
        parts = tuple(p[..., :n] for p, n in zip(parts, widths))

    def whole(w, b):
        if n_samples is not None:
            d = parts[0].shape[-1]
            z = parts[0] @ w[:, :d].t()
            z_ray = partial_products(w[:, d:], b, parts[1:])
            return (z.reshape(-1, n_samples, z.shape[-1]) + z_ray[:, None, :]).reshape(z.shape)
        if scale is None:
            return partial_products(w, b, parts)
        return partial_products(w, None, parts) * scale + b

    return whole(w, b) if outs is None else tuple(whole(w[o], b[o]) for o in outs)


def unpadded(y, d_out):
    return y if isinstance(y, tuple) else y[..., :d_out]


def record_calls(monkeypatch):
    calls = []

    def recorder(layer, x, dtype=None, **kw):
        calls.append((layer, x, dtype, kw))
        return layers.linear(layer, x, dtype, **kw)

    for mod in (sdf, color, nerf_bg):
        monkeypatch.setattr(mod, "linear", recorder)
    return calls


def derivatives(fn, leaves, seed):
    """fn(), the first derivatives of <fn(), r> in every leaf (kept in the
    graph) and the derivatives of <first, q> in every leaf, r and q drawn
    from ``seed``."""
    ys = fn()
    ys = ys if isinstance(ys, tuple) else (ys,)
    gen = torch.Generator().manual_seed(seed)
    r = [torch.randn(y.shape, generator=gen, dtype=y.dtype) for y in ys]
    first = torch.autograd.grad(ys, leaves, r, create_graph=True, allow_unused=True)
    first = [torch.zeros_like(l) if f is None else f for f, l in zip(first, leaves)]
    q = [torch.randn(l.shape, generator=gen, dtype=l.dtype) for l in leaves]
    total = sum((f * qi).sum() for f, qi in zip(first, q) if f.requires_grad)
    second = torch.autograd.grad(total, leaves, allow_unused=True) if torch.is_tensor(
        total) else [None] * len(leaves)
    second = [torch.zeros_like(l) if s is None else s for s, l in zip(second, leaves)]
    return list(ys), first, second


@pytest.mark.parametrize("per_ray", [True, False])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_linear_matches_partial_products_float64(config, per_ray, monkeypatch):
    """In float64, every linear of the SDF (with the feature and without),
    colour and background nets equals the partial-product formula, in its
    value and in its first and second derivatives in its inputs and its
    parameters (``scale``, ``n_samples`` and ``outs`` included)."""
    fc, model = field(config, seed=3, noise=0.05)
    model = model.double()
    pts, d, a, pts4 = inputs(4, torch.float64)
    calls = record_calls(monkeypatch)
    f64 = torch.float64
    n = SAMPLES if per_ray else None
    dd = d if per_ray else layers.per_sample(d, SAMPLES)
    aa = a if per_ray else layers.per_sample(a, SAMPLES)
    with torch.no_grad():
        s, feat = sdf.apply_sdf_split(model.neuconw.sdf_net, fc.sdf_cfg, pts, f64)
        sdf.apply_sdf_split(model.neuconw.sdf_net, fc.sdf_cfg, pts, f64, with_feature=False)
        normals = torch.randn(pts.shape, dtype=f64, generator=torch.Generator().manual_seed(5))
        color.apply_color(model.neuconw.color_net, fc.color_cfg, fc.encode_a, pts, normals, dd,
                          feat, aa, act_dtype=f64, n_samples=n)
        nerf_bg.apply_nerf_bg(model.nerf, fc.encode_a_bg, pts4, dd, aa, act_dtype=f64,
                              n_samples=n)
    kinds = {(isinstance(x, tuple), kw.get("scale") is not None, kw.get("n_samples") is not None,
              len(kw.get("outs") or ())) for _, x, _, kw in calls}
    assert len(calls) == 9 + 9 + 8 + 15
    assert {(True, True, False, 0), (False, False, False, 2), (False, False, False, 1),
            (True, False, per_ray, 0)} <= kinds
    for i, (layer, x, dtype, kw) in enumerate(calls):
        parts = [t.detach().clone().requires_grad_(True)
                 for t in (x if isinstance(x, tuple) else (x,))]
        arg = tuple(parts) if isinstance(x, tuple) else parts[0]
        leaves = parts + list(layer.parameters())
        want = derivatives(lambda: reference_linear(layer, arg, dtype, **kw), leaves, i)
        d_out = want[0][0].shape[-1]
        if kw.get("padded"):
            full = layers.linear(layer, arg, dtype, **kw)
            assert full.shape[-1] % layers.align_of(dtype) == 0 and not full[..., d_out:].any()
        got = derivatives(lambda: unpadded(layers.linear(layer, arg, dtype, **kw), d_out),
                          leaves, i)
        for name, g, w in zip(("value", "first", "second"), got, want):
            assert len(g) == len(w)
            for j, (gj, wj) in enumerate(zip(g, w)):
                assert gj.shape == wj.shape, (i, name, j)
                torch.testing.assert_close(gj, wj, rtol=1e-10, atol=1e-10,
                                           msg=f"call {i} ({layer}), {name} {j}")


def test_positional_encoding_width_pads_with_zeros():
    x = torch.randn(5, 3, dtype=torch.float64)
    plain = layers.positional_encoding(x, 6)
    wide = layers.positional_encoding(x, 6, width=layers.aligned_width(39, torch.bfloat16))
    assert plain.shape == (5, 39) and wide.shape == (5, 40)
    assert torch.equal(wide[:, :39], plain) and not wide[:, 39:].any()
    assert layers.aligned_width(84, torch.float32) == 84
    assert layers.aligned_width(84, torch.bfloat16) == 88
    assert layers.aligned_width(473, torch.bfloat16) == 480


# The parent's NeuconWField state dict at the brandenburg_gate widths (bg_op
# and bg_ref alike), name -> shape: the padding leaves every parameter as it was.
_SDF = {f"neuconw.sdf_net.lin{l}": (d_out, d_in) for l, (d_in, d_out) in enumerate(
    [(39, 512), (512, 512), (512, 512), (512, 473), (512, 512), (512, 512), (512, 512),
     (512, 512), (512, 513)])}
_COLOR_WN = {f"neuconw.color_net.lin{l}": s for l, s in enumerate(
    [(256, 134), (256, 256), (256, 256), (256, 256), (3, 256)])}
_PLAIN = {"neuconw.color_net.xyz_encoding_final": (512, 512),
          "neuconw.color_net.static_encoding.static_linear_0": (128, 587),
          "neuconw.color_net.static_encoding.static_linear_1": (128, 128),
          **{f"nerf.pts_linears.{i}": (256, 84 if i == 0 else 340 if i == 5 else 256)
             for i in range(8)},
          "nerf.alpha_linear": (1, 256), "nerf.feature_linear": (256, 256),
          **{f"nerf.apperence_encoding.static_linear_{s}": (128, 331 if s == 0 else 128)
             for s in range(4)},
          "nerf.rgb_linear": (3, 128)}
PARENT_STATE = {"embedding_a.weight": (5000, 48), "neuconw.deviation_network.variance": (),
                **{f"{k}.{p}": s for k, (o, i) in {**_SDF, **_COLOR_WN}.items()
                   for p, s in (("weight_v", (o, i)), ("weight_g", (o, 1)), ("bias", (o,)))},
                **{f"{k}.{p}": s for k, (o, i) in _PLAIN.items()
                   for p, s in (("weight", (o, i)), ("bias", (o,)))}}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_state_dict_unchanged_and_parent_checkpoint_loads(config, tmp_path):
    """The field's parameter names and shapes are the parent's, and a
    checkpoint in the parent's layout (``training/checkpoint.
    save_checkpoint``: the state dict as float32, the two dead reference
    entries, the step) loads strictly and runs."""
    from neuralrecon_w_tpu_torch.training.checkpoint import load_field

    fc = field_config_from_cfg(load_cfg(os.path.join(ROOT, CONFIGS[config])))
    state = NeuconWField(fc, device="meta").state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == PARENT_STATE
    assert len(PARENT_STATE) == 80
    gen = torch.Generator().manual_seed(7)
    sd = {k: torch.randn(s, generator=gen) * 0.05 for k, s in PARENT_STATE.items()}
    path = str(tmp_path / "step_1.ckpt")
    torch.save({"state_dict": with_dead_entries(sd, encode_a_bg=True), "global_step": 1,
                "epoch": 0}, path)
    model = load_field(path, fc, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    pts, d, a, pts4 = inputs(2)
    with torch.no_grad():
        s = sdf.sdf_value(model.neuconw.sdf_net, fc.sdf_cfg, pts, torch.float32)
        density, rgb = nerf_bg.apply_nerf_bg(model.nerf, fc.encode_a_bg, pts4, d, a,
                                             n_samples=SAMPLES)
    assert s.shape == (RAYS * SAMPLES,) and torch.isfinite(s).all()
    assert density.shape == (RAYS * SAMPLES, 1) and rgb.shape == (RAYS * SAMPLES, 3)
