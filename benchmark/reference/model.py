"""The NeuS-W field on a dict of weights (the reference checkpoint's names):
the SDF net with its input gradient, the IDR colour head with the NeRF-W
appearance head, the background NeRF++ and the deviation, every product
through a ``Precision``. Copied from the port's ``models/sdf.py``,
``models/color.py``, ``models/nerf_bg.py``, ``models/neuconw.py`` and
``models/layers.py``, with the concatenations made."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NERF_D, NERF_SKIP = 8, 4


def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{n-1} x), cos(2^{n-1} x)]."""
    feats = [x]
    for i in range(n_freqs):
        feats += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(feats, -1)


def weight(p: dict, name: str) -> torch.Tensor:
    """A linear's weight, (d_out, d_in): v g / |v| row by row where the
    layer is weight-normed."""
    if f"{name}.weight" in p:
        return p[f"{name}.weight"]
    v, g = p[f"{name}.weight_v"], p[f"{name}.weight_g"]
    return v * (g / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True), min=1e-12))


def linear(p: dict, prec, name: str, x: torch.Tensor) -> torch.Tensor:
    return prec.linear(x, weight(p, name), p[f"{name}.bias"])


def sdf_net(p: dict, sdf: dict, prec, x: torch.Tensor):
    """(N, 3) -> (sdf (N,), feature (N, d_out - 1))."""
    n_layers = sdf["n_layers"] + 1
    x = x * sdf["scale"]
    inputs = encode(x, sdf["multires"]) if sdf["multires"] > 0 else x
    h = inputs
    for l in range(n_layers - 1):
        if l in tuple(sdf["skip_in"]):
            h = torch.cat([h, inputs], -1) / math.sqrt(2)
        h = F.softplus(linear(p, prec, f"neuconw.sdf_net.lin{l}", h), beta=100.0, threshold=20.0)
    out = linear(p, prec, f"neuconw.sdf_net.lin{n_layers - 1}", h)
    return out[:, 0] / sdf["scale"], out[:, 1:]


def sdf_grad(p: dict, sdf: dict, prec, x: torch.Tensor, create_graph: bool):
    """(sdf (N,), feature, d sdf / d x (N, 3)); with create_graph the three
    keep their graph (training), else they are values."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        s, feat = sdf_net(p, sdf, prec, x)
        (g,) = torch.autograd.grad(s, x, torch.ones_like(s), create_graph=create_graph)
    if not create_graph:
        s, feat, g = s.detach(), feat.detach(), g.detach()
    return s, feat, g


def color(p: dict, cfg: dict, prec, points, normals, dirs, feature, a) -> torch.Tensor:
    """rgb (N, 3) in [0, 1]; every input per sample."""
    c = cfg["COLOR_CONFIG"]
    view = encode(dirs, c["multires_view"]) if c["multires_view"] > 0 else dirs
    net = "neuconw.color_net"
    if cfg["ENCODE_A"]:
        xyz = linear(p, prec, f"{net}.xyz_encoding_final", feature)
        h = torch.cat([xyz, view, a], -1)
        for s in range(c["static_head_layers"]):
            h = F.relu(linear(p, prec, f"{net}.static_encoding.static_linear_{s}", h))
        x = torch.cat([points, normals, h], -1)
    elif c["mode"] == "idr":
        x = torch.cat([points, view, normals, feature], -1)
    elif c["mode"] == "no_view_dir":
        x = torch.cat([points, normals, feature], -1)
    else:
        x = torch.cat([points, view, feature], -1)
    for l in range(c["n_layers"] + 1):
        x = linear(p, prec, f"{net}.lin{l}", F.relu(x) if l else x)
    return torch.sigmoid(x)


def background(p: dict, encode_a_bg: bool, prec, pts4, dirs, a):
    """(density (N, 1), rgb (N, 3)) of the NeRF++ at (N, 4) inverted-sphere
    coordinates; dirs and a per point."""
    pe = encode(pts4, 10)
    view = encode(dirs, 4)
    h = pe
    for i in range(NERF_D):
        h = F.relu(linear(p, prec, f"nerf.pts_linears.{i}",
                          torch.cat([pe, h], -1) if i - 1 == NERF_SKIP else h))
    alpha = linear(p, prec, "nerf.alpha_linear", h)
    feature = linear(p, prec, "nerf.feature_linear", h)
    if encode_a_bg:
        h = torch.cat([feature, view, a], -1)
        for s in range(NERF_D // 2):
            h = F.relu(linear(p, prec, f"nerf.apperence_encoding.static_linear_{s}", h))
    else:
        h = F.relu(linear(p, prec, "nerf.views_linears.0", torch.cat([feature, view], -1)))
    return alpha, linear(p, prec, "nerf.rgb_linear", h)


def inv_s(p: dict) -> torch.Tensor:
    return torch.clamp(torch.exp(p["neuconw.deviation_network.variance"] * 10.0), 1e-6, 1e6)
