"""Background NeRF++ (``neuralrecon_w_tpu/models/nerf_bg.py``; reference
models/nerf.py:86-182): D=8, W=256, input [xyz/r, 1/r] under PE 10,
views under PE 4, skip after layer 4 ([pe, h] feeds layer 5), and the
appearance head [feature, PE(view), a] -> 128 x 4 -> rgb.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .color import StaticEncoding, init_linear_, linear, weight_bias
from .layers import apply_linear_parts, pe_dim, positional_encoding
from .sdf import act_dtype_of

D = 8
W = 256
SKIPS = (4,)


class NeRF(nn.Module):
    """Names as the reference's ``nerf``: pts_linears.{i}, alpha_linear,
    feature_linear, rgb_linear and apperence_encoding.static_linear_{S}
    (ENCODE_A_BG) or views_linears.0."""

    def __init__(self, encode_appearance: bool, in_channels_a: int = 48, device=None):
        super().__init__()
        d_pe = pe_dim(4, 10)
        d_pe_view = pe_dim(3, 4)
        self.pts_linears = nn.ModuleList(
            [nn.Linear(d_pe, W, device=device)]
            + [nn.Linear(W + d_pe if (i - 1) in SKIPS else W, W, device=device)
               for i in range(1, D)])
        self.alpha_linear = nn.Linear(W, 1, device=device)
        self.feature_linear = nn.Linear(W, W, device=device)
        if encode_appearance:
            self.apperence_encoding = StaticEncoding(
                W + d_pe_view + in_channels_a, W // 2, D // 2, device)
        else:
            self.views_linears = nn.ModuleList(
                [nn.Linear(W + d_pe_view, W // 2, device=device)])
        self.rgb_linear = nn.Linear(W // 2, 3, device=device)


def init_nerf_bg_(net: NeRF, generator: torch.Generator) -> None:
    for module in net.modules():
        if isinstance(module, nn.Linear):
            init_linear_(module, generator)


def apply_nerf_bg(net: NeRF, encode_appearance: bool, pts4, view_dirs,
                  a_embedded=None, act_dtype=torch.float32, n_samples=None):
    """pts4 (N, 4) -> (density (N, 1), rgb (N, 3)), both f32
    (``nerf_bg.py:51-103``). n_samples: view_dirs / a_embedded per ray."""
    dt = act_dtype_of(act_dtype)
    pts4, view_dirs = pts4.to(dt), view_dirs.to(dt)
    if a_embedded is not None:
        a_embedded = a_embedded.to(dt)
    pe = positional_encoding(pts4, 10)
    pe_view = positional_encoding(view_dirs, 4)

    h = pe
    skipped = False
    for i, layer in enumerate(net.pts_linears):
        if skipped:
            w, b = weight_bias(layer, dt)
            h = F.relu(apply_linear_parts(w, b, (pe, h)))
        else:
            h = F.relu(linear(layer, h, dt))
        skipped = i in SKIPS

    alpha = linear(net.alpha_linear, h, dt)
    feature = linear(net.feature_linear, h, dt)

    def head(layer, ray_parts):
        w, b = weight_bias(layer, dt)
        d_f = feature.shape[-1]
        z = feature @ w[:, :d_f].t()
        z_ray = apply_linear_parts(w[:, d_f:], b, ray_parts)
        if n_samples is None:
            z = z + z_ray
        else:
            z = (z.reshape(-1, n_samples, z.shape[-1]) + z_ray[:, None, :]).reshape(z.shape)
        return F.relu(z)

    if encode_appearance:
        enc = net.apperence_encoding
        h = head(enc.layer(0), (pe_view, a_embedded))
        for s in range(1, enc.n_layers):
            h = F.relu(linear(enc.layer(s), h, dt))
    else:
        h = head(net.views_linears[0], (pe_view,))
    rgb = linear(net.rgb_linear, h, dt)
    return alpha.float(), rgb.float()
