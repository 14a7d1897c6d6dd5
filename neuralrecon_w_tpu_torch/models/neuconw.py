"""The complete NeuconW field (``neuralrecon_w_tpu/models/neuconw.py``).

``NeuconWField`` is an nn.Module tree whose state-dict names are the
reference Lightning checkpoint's (``tools/convert_torch_ckpt.py:10-19``):
``embedding_a.weight``, ``neuconw.sdf_net.*``, ``neuconw.color_net.*``,
``neuconw.deviation_network.variance`` and ``nerf.*``. The two modules
the reference builds but never runs (the wrapper-level
``neuconw.xyz_encoding_final`` and, with ENCODE_A_BG, the
``nerf.views_linears.0``) are not part of the tree.

Only grad_mode 'vjp' is ported: the sdf gradient is one autograd reverse
pass. The TPU-only 'fwd', 'pallas', 'pallas_hybrid' modes and the fused
'pallas_field' kernel are not.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import FieldConfig
from .color import RenderingNetwork, apply_color
from .nerf_bg import NeRF, apply_nerf_bg
from .sdf import SDFNetwork, act_dtype_of, sdf_value, sdf_value_feat_grad


class SingleVarianceNetwork(nn.Module):
    def __init__(self, init_val: float, device=None):
        super().__init__()
        self.variance = nn.Parameter(torch.tensor(float(init_val), device=device))


class NeuconWCore(nn.Module):
    def __init__(self, fc: FieldConfig, device=None):
        super().__init__()
        self.sdf_net = SDFNetwork(fc.sdf_cfg, device)
        self.color_net = RenderingNetwork(fc.color_cfg, fc.n_a, fc.encode_a, device)
        self.deviation_network = SingleVarianceNetwork(fc.s_init, device)


class NeuconWField(nn.Module):
    def __init__(self, fc: FieldConfig, device=None):
        super().__init__()
        self.embedding_a = nn.Embedding(fc.n_vocab, fc.n_a, device=device)
        self.neuconw = NeuconWCore(fc, device)
        self.nerf = NeRF(fc.encode_a_bg, fc.n_a, device)


def inv_s(model: NeuconWField) -> torch.Tensor:
    """exp(10 * variance), clamped to [1e-6, 1e6]."""
    return torch.clamp(torch.exp(model.neuconw.deviation_network.variance * 10.0), 1e-6, 1e6)


def field_sdf(model: NeuconWField, fc: FieldConfig, pts: torch.Tensor) -> torch.Tensor:
    """SDF probe, (..., 3) -> (...,)."""
    return sdf_value(model.neuconw.sdf_net, fc.sdf_cfg, pts, act_dtype_of(fc.act_dtype))


def field_forward(model: NeuconWField, fc: FieldConfig, pts, dirs, a_embedded,
                  n_samples=None, create_graph: bool = False):
    """Foreground field at flattened samples: rgb (N, 3), inv_s, sdf
    (N,), gradients (N, 3). dirs / a_embedded are per ray when
    n_samples is set (``neuconw.py:117-182``)."""
    if fc.grad_mode != "vjp":
        raise NotImplementedError(
            f"SDF_GRAD_MODE={fc.grad_mode!r} is not ported; use 'vjp'")
    act = act_dtype_of(fc.act_dtype)
    sdf, feat, grad = sdf_value_feat_grad(
        model.neuconw.sdf_net, fc.sdf_cfg, pts, act, create_graph=create_graph)
    rgb = apply_color(model.neuconw.color_net, fc.color_cfg, fc.encode_a, pts, grad,
                      dirs, feat, a_embedded, act_dtype=act, n_samples=n_samples)
    return rgb, inv_s(model), sdf, grad


def field_background(model: NeuconWField, fc: FieldConfig, pts4, dirs, a_embedded,
                     n_samples=None):
    """Background NeRF at (N, 4) inverted-sphere coordinates."""
    if fc.bg_mode != "xla":
        raise NotImplementedError("the fused background kernel is not ported")
    a = a_embedded if fc.encode_a_bg else None
    return apply_nerf_bg(model.nerf, fc.encode_a_bg, pts4, dirs, a,
                         act_dtype=act_dtype_of(fc.act_dtype), n_samples=n_samples)
