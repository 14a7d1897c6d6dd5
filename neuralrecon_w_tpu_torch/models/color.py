"""IDR radiance network with the NeRF-W appearance head
(``neuralrecon_w_tpu/models/color.py``; reference RenderingNetwork,
models/neuconw.py:59-170).

With ``encode_a``: xyz_encoding_final = Linear(512, 512) on the geometry
feature; static head [xyz_final, PE(view), a] -> 128 -> 128 (ReLU);
main branch [points, normals, head] -> 4 x 256 -> 3, weight-normed,
sigmoid output.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import WNLinear, linear, pe_dim, per_sample, positional_encoding
from .sdf import act_dtype_of


def color_dims(cfg, in_channels_a: int, encode_a: bool):
    d_view_pe = pe_dim(3, cfg["multires_view"]) if cfg["multires_view"] > 0 else 3
    if encode_a:
        d0 = cfg["d_in"] + cfg["head_channels"] - 3
    else:
        d0 = cfg["d_in"] + cfg["d_feature"] + (d_view_pe - 3 if cfg["multires_view"] > 0 else 0)
    dims = [d0] + [cfg["d_hidden"]] * cfg["n_layers"] + [cfg["d_out"]]
    d_head_in = cfg["d_feature"] + in_channels_a + d_view_pe
    return dims, d_head_in, d_view_pe


class StaticEncoding(nn.Module):
    def __init__(self, d_in: int, width: int, n_layers: int, device=None):
        super().__init__()
        for s in range(n_layers):
            setattr(self, f"static_linear_{s}",
                    nn.Linear(d_in if s == 0 else width, width, device=device))
        self.n_layers = n_layers

    def layer(self, s: int) -> nn.Linear:
        return getattr(self, f"static_linear_{s}")


class RenderingNetwork(nn.Module):
    """Names as the reference's ``color_net``: lin{L},
    xyz_encoding_final, static_encoding.static_linear_{S}."""

    def __init__(self, cfg: dict, in_channels_a: int, encode_a: bool, device=None):
        super().__init__()
        dims, d_head_in, _ = color_dims(cfg, in_channels_a, encode_a)
        lin = WNLinear if cfg["weight_norm"] else nn.Linear
        self.n_layers = len(dims) - 1
        for l in range(self.n_layers):
            setattr(self, f"lin{l}", lin(dims[l], dims[l + 1], device=device))
        if encode_a:
            self.xyz_encoding_final = nn.Linear(cfg["d_feature"], cfg["d_feature"], device=device)
            self.static_encoding = StaticEncoding(
                d_head_in, cfg["head_channels"], cfg["static_head_layers"], device)

    def layer(self, l: int) -> nn.Module:
        return getattr(self, f"lin{l}")


@torch.no_grad()
def init_linear_(layer: nn.Module, generator: torch.Generator) -> None:
    """Torch-default Linear init U(+-1/sqrt(d_in)) for weight and bias,
    drawn from ``generator``; a weight-normed layer gets g = ||v||."""
    w_ref = layer.weight_v if isinstance(layer, WNLinear) else layer.weight
    d_out, d_in = w_ref.shape
    bound = 1.0 / math.sqrt(d_in)
    w = (torch.rand(d_out, d_in, generator=generator) * 2 - 1) * bound
    b = (torch.rand(d_out, generator=generator) * 2 - 1) * bound
    w_ref.copy_(w.to(w_ref.device))
    layer.bias.copy_(b.to(w_ref.device))
    if isinstance(layer, WNLinear):
        layer.weight_g.copy_(torch.linalg.vector_norm(layer.weight_v, dim=1, keepdim=True))


def init_color_(net: RenderingNetwork, generator: torch.Generator) -> None:
    for module in net.modules():
        if isinstance(module, (nn.Linear, WNLinear)):
            init_linear_(module, generator)


def apply_color(net: RenderingNetwork, cfg: dict, encode_a: bool, points, normals,
                view_dirs, feature, a_embedded=None, act_dtype=torch.float32,
                n_samples=None):
    """rgb (N, 3) in [0, 1] (``color.py:60-129``). With n_samples set,
    view_dirs and a_embedded are per ray, (N // n_samples, d), and their
    head contribution is computed once per ray and broadcast."""
    dt = act_dtype_of(act_dtype)
    cast = lambda t: None if t is None else t.to(dt)  # noqa: E731
    points, normals, view_dirs = cast(points), cast(normals), cast(view_dirs)
    feature, a_embedded = cast(feature), cast(a_embedded)

    if cfg["multires_view"] > 0:
        view_dirs = positional_encoding(view_dirs, cfg["multires_view"])

    if encode_a:
        xyz_final = linear(net.xyz_encoding_final, feature, dt)
        head = net.static_encoding
        h = F.relu(linear(head.layer(0), (xyz_final, view_dirs, a_embedded), dt,
                          n_samples=n_samples))
        for s in range(1, head.n_layers):
            h = F.relu(linear(head.layer(s), h, dt))
        first_parts = (points, normals, h)
    else:
        view_dirs, a_embedded = per_sample(view_dirs, n_samples), per_sample(a_embedded, n_samples)
        if cfg["mode"] == "idr":
            first_parts = (points, view_dirs, normals, feature)
        elif cfg["mode"] == "no_view_dir":
            first_parts = (points, normals, feature)
        else:  # no_normal
            first_parts = (points, view_dirs, feature)

    x = linear(net.layer(0), first_parts, dt)
    for l in range(1, net.n_layers):
        x = linear(net.layer(l), F.relu(x), dt)
    return torch.sigmoid(x.float())
