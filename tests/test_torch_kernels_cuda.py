"""PyTorch port, the Hopper kernels against their plain versions on the
card. Marked ``cuda``; every test skips without a CUDA device. JAX is not
needed here (on a machine without JAX run with ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

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
    from neuralrecon_w_tpu_torch.tools.convert import init_field

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


@pytest.mark.parametrize("n_pts", [N_RAYS, 1000])  # 1000: a ragged last tile
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
    wide = torch.sort(torch.rand(N_RAYS, 60, device=dev), dim=1).values
    with pytest.raises(ValueError):  # rows wider than the kernel holds
        smp.up_sample_round(o, d, wide, wide, None, None, 8, 512.0, True)
    with pytest.raises(ValueError):  # sdf rows that do not match z
        smp.up_sample_round(o, d, z, z[:, :4], None, None, 8, 512.0, True)
