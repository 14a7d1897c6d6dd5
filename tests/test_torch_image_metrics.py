"""PyTorch port, the image metrics: SSIM, and LPIPS over VGG16 and AlexNet,
against the JAX package's on the same seeded images and weights (carried
across with ``tools/convert.lpips_from_jax``), the lpips package's state
dict layout loaded strictly, and the heads-only checkpoint refused."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neuralrecon_w_tpu.training import lpips as jax_lpips  # noqa: E402
from neuralrecon_w_tpu.training import metrics as jax_metrics  # noqa: E402
from neuralrecon_w_tpu_torch.tools.convert import lpips_from_jax  # noqa: E402
from neuralrecon_w_tpu_torch.training import lpips, metrics  # noqa: E402

torch.set_num_threads(2)

SSIM_REL = 1e-6
LPIPS_REL = 1e-5


def images(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.15 * rng.standard_normal(shape).astype(np.float32), 0, 1)
    return a, b


@pytest.mark.parametrize("shape", [(48, 40, 3), (32, 32, 1)])
def test_ssim_matches_jax(shape):
    a, b = images(shape, 0)
    want = float(jax_metrics.ssim(a, b))
    got = metrics.ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=SSIM_REL)
    assert float(metrics.ssim(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(1.0)
    f64 = metrics.ssim(torch.from_numpy(a).double(), torch.from_numpy(b).double())
    assert f64.dtype == torch.float64 and float(f64) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("net,width_mult,batch", [("vgg", 0.125, 2), ("alex", 0.125, 2),
                                                   ("vgg", 1.0, 1)])
def test_lpips_matches_jax(net, width_mult, batch):
    """init_lpips's JAX weights through lpips_from_jax: the same distance on
    64x64 images, batched (N, H, W, 3) and single (H, W, 3)."""
    params = jax_lpips.init_lpips(jax.random.PRNGKey(3), net=net, width_mult=width_mult)
    model = lpips_from_jax(jax.tree.map(np.asarray, {k: v for k, v in params.items()
                                                     if k != "net"}), net, "cpu")
    a, b = images((batch, 64, 64, 3), 1)
    fn = jax.jit(lambda x, y: jax_lpips.lpips(params, x, y))
    want = float(fn(a, b))
    got = lpips.lpips(model, a, b)
    assert got.dim() == 0 and float(got) == pytest.approx(want, rel=LPIPS_REL)
    want0 = float(fn(a[0], b[0]))
    assert float(lpips.lpips(model, a[0], b[0])) == pytest.approx(want0, rel=LPIPS_REL)
    assert float(lpips.lpips(model, a[0], a[0])) == pytest.approx(0.0, abs=1e-7)


def lpips_package_state_dict(net, seed=0, width_mult=0.125):
    """A state dict with the lpips package's keys (torchvision's conv
    indices, scaling buffers, lin / lins heads) at reduced widths."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in lpips.LPIPS(net, width_mult, device="cpu").state_dict().items():
        sd[k] = v.clone() if k.startswith("scaling") else torch.randn(v.shape, generator=g) * 0.2
    for k in range(5):
        sd[f"lins.{k}.model.1.weight"] = sd[f"lin{k}.model.1.weight"] = sd[
            f"lin{k}.model.1.weight"].abs()
    return sd


def test_state_dict_layouts_load_strictly(tmp_path):
    """The package's layout loads strictly into LPIPS and through
    load_torch_state_dict (a path); tests/test_lpips.py's slice-local
    layout loads through load_torch_state_dict too, and both give JAX's
    distance on the same dict."""
    from test_lpips import _synthetic_vgg_state_dict

    a, b = images((40, 40, 3), 2)
    for net in ("vgg", "alex"):
        sd = lpips_package_state_dict(net)
        model = lpips.LPIPS(net, 0.125, device="cpu")
        model.load_state_dict(sd, strict=True)
        path = str(tmp_path / f"{net}.pth")
        torch.save(sd, path)
        loaded = lpips.load_torch_state_dict(path, net, device="cpu")
        want = float(jax_lpips.lpips(jax_lpips.load_torch_state_dict(
            {k: v.numpy() for k, v in sd.items()}, net), a, b))
        for m in (model, loaded):
            assert float(lpips.lpips(m, a, b)) == pytest.approx(want, rel=LPIPS_REL)
        assert float(metrics.lpips_loss(a, b, net, path, device="cpu")) == pytest.approx(
            want, rel=LPIPS_REL)
    local = _synthetic_vgg_state_dict(np.random.RandomState(7))
    want = float(jax_lpips.lpips(jax_lpips.load_torch_state_dict(local, "vgg"), a, b))
    got = lpips.lpips(lpips.load_torch_state_dict(local, "vgg", device="cpu"), a, b)
    assert float(got) == pytest.approx(want, rel=LPIPS_REL)


def test_heads_only_and_missing_weights_refused():
    rs = np.random.RandomState(9)
    sd = {f"lin{i}.model.1.weight": np.abs(rs.randn(1, 8, 1, 1)) for i in range(5)}
    with pytest.raises(ValueError, match="not a full"):
        lpips.load_torch_state_dict(sd, "vgg", device="cpu")
    with pytest.raises(RuntimeError, match="pretrained conv weights"):
        metrics.lpips_loss(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)), "vgg", None)


def test_vgg16_features_has_torchvision_indices():
    convs = [i for i, m in enumerate(lpips.vgg16_features(device="cpu"))
             if isinstance(m, torch.nn.Conv2d)]
    assert convs == [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    alex = lpips.alexnet_features(device="cpu")
    assert [(i, m.kernel_size, m.stride, m.padding) for i, m in enumerate(alex)
            if isinstance(m, torch.nn.Conv2d)][:2] == [(0, (11, 11), (4, 4), (2, 2)),
                                                       (3, (5, 5), (1, 1), (2, 2))]
