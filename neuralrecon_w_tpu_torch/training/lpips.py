"""LPIPS perceptual distance (Zhang et al. 2018), the port's counterpart of
``neuralrecon_w_tpu/training/lpips.py``: an ``nn.Module`` whose state-dict
names are the ``lpips`` package's, so that a saved
``lpips.LPIPS(net=...).state_dict()`` loads with strict=True:

    scaling_layer.{shift,scale}           buffers (1, 3, 1, 1)
    net.slice{1..5}.{i}.{weight,bias}     convs at torchvision's indices
    lin{k}.model.1.weight, lins.{k}...    (1, C, 1, 1) heads (one module,
                                          two names, as the package's)

The VGG16 / AlexNet trunks are built here with torchvision's module
indices (``vgg16_features``, ``alexnet_features``); the NIMA filter
(``tools/prepare_data/filters.py``) reuses the VGG16 one. No torchvision
and no download: weights come from a local state dict. ``init_lpips``
draws random weights, a valid graph for tests but no calibrated metric.

The convolutions run through cuDNN on the card, and so in TF32 wherever
``torch.backends.cudnn.allow_tf32`` is set (torch's default): the metric
follows that global flag.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import default_device

# torchvision's vgg16 ('D') and alexnet feature plans; an int is a conv
# (+ ReLU), 'M' a max-pool
_VGG_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
_ALEX_CHANNELS = (64, 192, 384, 256, 256)
# the lpips package's slices of the trunk: module index ranges
_SLICES = {"vgg": ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30)),
           "alex": ((0, 2), (2, 5), (5, 8), (8, 10), (10, 12))}
# the lpips package's ScalingLayer: inputs in [-1, 1], ImageNet statistics
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _widths(net: str, width_mult: float) -> tuple:
    base = [c for c in _VGG_PLAN if c != "M"] if net == "vgg" else _ALEX_CHANNELS
    return tuple(max(1, int(c * width_mult)) for c in base)


def vgg16_features(channels=None, device=None) -> nn.Sequential:
    """torchvision's ``vgg16().features`` layout (convs at 0, 2, 5, 7, 10,
    12, 14, 17, 19, 21, 24, 26, 28); ``channels`` the 13 conv widths
    (default: the full 64 ... 512)."""
    widths = iter(channels or _widths("vgg", 1.0))
    layers, c_in = [], 3
    for v in _VGG_PLAN:
        if v == "M":
            layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
        else:
            c_out = next(widths)
            layers += [nn.Conv2d(c_in, c_out, 3, padding=1, device=device), nn.ReLU()]
            c_in = c_out
    return nn.Sequential(*layers)


def alexnet_features(channels=None, device=None) -> nn.Sequential:
    """torchvision's ``alexnet().features`` layout: conv 11x11 stride 4 pad
    2, pool 3/2, conv 5x5 pad 2, pool 3/2, three 3x3 convs, pool 3/2."""
    c = channels or _widths("alex", 1.0)
    return nn.Sequential(
        nn.Conv2d(3, c[0], 11, stride=4, padding=2, device=device), nn.ReLU(),
        nn.MaxPool2d(3, 2),
        nn.Conv2d(c[0], c[1], 5, padding=2, device=device), nn.ReLU(),
        nn.MaxPool2d(3, 2),
        nn.Conv2d(c[1], c[2], 3, padding=1, device=device), nn.ReLU(),
        nn.Conv2d(c[2], c[3], 3, padding=1, device=device), nn.ReLU(),
        nn.Conv2d(c[3], c[4], 3, padding=1, device=device), nn.ReLU(),
        nn.MaxPool2d(3, 2),
    )


class _Trunk(nn.Module):
    """``net``: the trunk's modules split into ``slice1`` ... ``slice5``
    under their torchvision indices."""

    def __init__(self, features: nn.Sequential, slices):
        super().__init__()
        for k, (lo, hi) in enumerate(slices):
            s = nn.Sequential()
            for i in range(lo, hi):
                s.add_module(str(i), features[i])
            setattr(self, f"slice{k + 1}", s)

    def forward(self, x):
        feats = []
        for k in range(5):
            x = getattr(self, f"slice{k + 1}")(x)
            feats.append(x)
        return feats


class _ScalingLayer(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT, device=device)[None, :, None, None])
        self.register_buffer("scale", torch.tensor(_SCALE, device=device)[None, :, None, None])

    def forward(self, x):
        return (x - self.shift) / self.scale


class _NetLin(nn.Module):
    """A 1x1 head without bias behind a dropout, as the package's
    NetLinLayer (``model.1.weight``)."""

    def __init__(self, c_in: int, device=None):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(c_in, 1, 1, bias=False, device=device))


class LPIPS(nn.Module):
    """LPIPS over a VGG16 ('vgg') or AlexNet ('alex') trunk. ``width_mult``
    shrinks every conv (for tests); ``channels`` gives the conv widths
    outright (13 for vgg, 5 for alex; a state dict's, on load)."""

    def __init__(self, net: str = "vgg", width_mult: float = 1.0, channels=None, device=None):
        super().__init__()
        if net not in _SLICES:
            raise ValueError(f"net must be 'vgg' or 'alex', got {net!r}")
        device = default_device(device)
        self.net_type = net
        channels = tuple(channels or _widths(net, width_mult))
        build = vgg16_features if net == "vgg" else alexnet_features
        self.scaling_layer = _ScalingLayer(device)
        self.net = _Trunk(build(channels, device), _SLICES[net])
        # each slice's output width: its last conv's
        outs = [[m.out_channels for m in getattr(self.net, f"slice{k + 1}")
                 if isinstance(m, nn.Conv2d)][-1] for k in range(5)]
        for k, c in enumerate(outs):
            setattr(self, f"lin{k}", _NetLin(c, device))
        self.lins = nn.ModuleList([getattr(self, f"lin{k}") for k in range(5)])
        self.eval()

    def conv_names(self) -> list:
        """The trunk's convs' names, slice by slice, in order."""
        return [n for n, m in self.net.named_modules(prefix="net") if isinstance(m, nn.Conv2d)]


@torch.no_grad()
def init_lpips(generator: torch.Generator, net: str = "vgg", width_mult: float = 1.0,
               device=None) -> LPIPS:
    """Random weights in the JAX package's scheme (``lpips.py:57-88``):
    conv weights normal / sqrt(fan_in), zero biases, heads |normal| / C."""
    model = LPIPS(net, width_mult, device=device)
    dev = next(model.parameters()).device
    for name in model.conv_names():
        conv = model.get_submodule(name)
        w = conv.weight
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        w.copy_(torch.randn(w.shape, generator=generator).to(dev) / np.sqrt(fan_in))
        conv.bias.zero_()
    for lin in model.lins:
        w = lin.model[1].weight
        w.copy_(torch.randn(w.shape, generator=generator).abs().to(dev) / w.shape[1])
    return model


def _nchw(img, device) -> torch.Tensor:
    img = torch.as_tensor(img, device=device)
    if img.dim() == 3:
        img = img[None]
    return (img * 2.0 - 1.0).permute(0, 3, 1, 2)


def _unit(t: torch.Tensor) -> torch.Tensor:
    """Channels scaled to unit length, +1e-10 inside the sqrt."""
    return t / torch.sqrt(torch.sum(t * t, dim=1, keepdim=True) + 1e-10)


def lpips(model: LPIPS, pred, gt) -> torch.Tensor:
    """LPIPS distance between (H, W, 3) or (N, H, W, 3) images in [0, 1]
    (``lpips.py:116-139``): scaled to [-1, 1], shifted and scaled, each
    layer's channels unit-normalised (+1e-10 inside the sqrt), squared
    difference, the head's channel dot, spatial mean, summed over the
    layers; the batch mean, a 0-d tensor on the model's device, in its
    dtype."""
    p0 = next(model.parameters())
    with torch.no_grad():
        x = model.scaling_layer(_nchw(pred, p0.device).to(p0.dtype))
        y = model.scaling_layer(_nchw(gt, p0.device).to(p0.dtype))
        total = 0.0
        for hp, hg, lin in zip(model.net(x), model.net(y), model.lins):
            diff = (_unit(hp) - _unit(hg)) ** 2
            per_pixel = torch.einsum("nchw,c->nhw", diff, lin.model[1].weight.reshape(-1))
            total = total + per_pixel.mean(dim=(1, 2))
        return total.mean()


def load_torch_state_dict(path_or_dict, net: str = "vgg", device=None) -> LPIPS:
    """An ``LPIPS`` module from a saved ``lpips.LPIPS(net=...).state_dict()``
    (a path, or the dict). Each slice's convs are taken in index order, so
    a dict with slice-local indices loads too; the scaling buffers are the
    package's constants where the dict lacks them. A heads-only checkpoint
    (the package's ``weights/v0.1/*.pth``) is refused."""
    if isinstance(path_or_dict, (str, bytes)):
        sd = torch.load(path_or_dict, map_location="cpu", weights_only=True)
    else:
        sd = path_or_dict
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}

    convs = []
    for si in range(5):
        prefix = f"net.slice{si + 1}."
        idxs = sorted({int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix)})
        found = [(sd[f"{prefix}{i}.weight"], sd[f"{prefix}{i}.bias"])
                 for i in idxs if f"{prefix}{i}.weight" in sd]
        if not found:
            raise ValueError(
                f"no conv weights under {prefix!r}: not a full "
                "lpips.LPIPS state_dict (save with .state_dict() on the "
                "whole module, not the lin-heads-only checkpoint)")
        convs += found
    model = LPIPS(net, channels=[w.shape[0] for w, _ in convs], device=device)
    full = {}
    for name, (w, b) in zip(model.conv_names(), convs):
        full[f"{name}.weight"], full[f"{name}.bias"] = w, b
    for k in range(5):
        head = sd[f"lin{k}.model.1.weight"]
        full[f"lin{k}.model.1.weight"] = full[f"lins.{k}.model.1.weight"] = head
    for b in ("shift", "scale"):
        key = f"scaling_layer.{b}"
        full[key] = sd.get(key, getattr(model.scaling_layer, b).cpu())
    model.load_state_dict(full, strict=True)
    return model
