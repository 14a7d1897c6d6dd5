"""The complete NeuconW field (``neuralrecon_w_tpu/models/neuconw.py``).

``NeuconWField`` is an nn.Module tree whose state-dict names are the
reference Lightning checkpoint's (``tools/convert_torch_ckpt.py:10-19``):
``embedding_a.weight``, ``neuconw.sdf_net.*``, ``neuconw.color_net.*``,
``neuconw.deviation_network.variance`` and ``nerf.*``. The two modules
the reference builds but never runs (the wrapper-level
``neuconw.xyz_encoding_final`` and, with ENCODE_A_BG, the
``nerf.views_linears.0``) are not part of the tree.

The SDF gradient modes (``TPU.SDF_GRAD_MODE``): 'vjp', one autograd
reverse pass, differentiated again by autograd in training (the double
backward, create_graph=True); 'pallas', the SDF-VJP kernels K3 / K4 / K5
(``ops/sdf_field_vjp.py``; their plain version on CPU tensors);
'pallas_hybrid', the plain forward with the kernels' backward; and
'pallas_field', the whole field (SDF, gradient and colour head, per sample)
through the fused field kernels, K6 forward and K7 + K5 backward
(``ops/field_train.py``); and 'fwd', the gradient by forward mode (one
primal and three tangent passes, ``models/sdf.sdf_value_feat_grad_fwdmode``),
differentiated reverse over forward in training, its SDF net in float32
whatever the field's dtype, as the JAX package's.
``TPU.FUSED_BG`` (``bg_mode`` 'pallas') sends the background through the
fused NeRF++ kernels K8 / K9 (``ops/nerf_bg_fused.py``).

Gradient-free colour probes go through kernel 3's port instead: mesh
vertex colouring (``parallel/sweep.sharded_rgb_sweep``) calls
``ops/field_forward.fused_field_forward`` (K6, ``csrc/field_fwd.cu``)
when the field has an appearance code, and ``field_rgb`` here otherwise.

``NeuconWField`` is built on the card unless the caller names a device
(``device.default_device``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import FieldConfig
from ..device import default_device
from .color import RenderingNetwork, apply_color
from .nerf_bg import NeRF, apply_nerf_bg
from .sdf import (SDFNetwork, act_dtype_of, sdf_value, sdf_value_feat_grad,
                  sdf_value_feat_grad_fwdmode)


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
        device = default_device(device)
        self.embedding_a = nn.Embedding(fc.n_vocab, fc.n_a, device=device)
        self.neuconw = NeuconWCore(fc, device)
        self.nerf = NeRF(fc.encode_a_bg, fc.n_a, device)


def inv_s(model: NeuconWField) -> torch.Tensor:
    """exp(10 * variance), clamped to [1e-6, 1e6]."""
    return torch.clamp(torch.exp(model.neuconw.deviation_network.variance * 10.0), 1e-6, 1e6)


def field_sdf(model: NeuconWField, fc: FieldConfig, pts: torch.Tensor) -> torch.Tensor:
    """SDF probe, (..., 3) -> (...,)."""
    return sdf_value(model.neuconw.sdf_net, fc.sdf_cfg, pts, act_dtype_of(fc.act_dtype))


def _per_sample(t, n_samples: int):
    """Per-ray rows (R, d) repeated for each of a ray's n_samples samples;
    autograd sums their cotangents back per ray."""
    if t is None:
        return None
    return t[:, None, :].expand(t.shape[0], n_samples, t.shape[-1]).reshape(-1, t.shape[-1])


def field_forward(model: NeuconWField, fc: FieldConfig, pts, dirs, a_embedded,
                  n_samples=None, create_graph: bool = False):
    """Foreground field at flattened samples: rgb (N, 3), inv_s, sdf
    (N,), gradients (N, 3). dirs / a_embedded are per ray when
    n_samples is set (``neuconw.py:117-182``). create_graph keeps the
    'vjp' and 'fwd' modes' sdf, feature and gradient in the autograd graph,
    as training needs; the kernel modes are always differentiable."""
    act = act_dtype_of(fc.act_dtype)
    if fc.grad_mode == "pallas_field":
        # the fused kernels take per-sample dirs and a (neuconw.py:132-149)
        from ..ops.field_train import field_rgb_sdf_grad_kernel

        if n_samples is not None:
            dirs, a_embedded = _per_sample(dirs, n_samples), _per_sample(a_embedded, n_samples)
        rgb, sdf, grad = field_rgb_sdf_grad_kernel(model, fc, pts, dirs, a_embedded)
        return rgb, inv_s(model), sdf, grad
    if fc.grad_mode in ("pallas", "pallas_hybrid"):
        from ..ops.sdf_field_vjp import sdf_value_feat_grad_kernel

        sdf, feat, grad = sdf_value_feat_grad_kernel(
            model.neuconw.sdf_net, fc.sdf, pts, act,
            fwd_impl="plain" if fc.grad_mode == "pallas_hybrid" else "kernel")
    elif fc.grad_mode == "fwd":
        with torch.set_grad_enabled(create_graph and torch.is_grad_enabled()):
            sdf, feat, grad = sdf_value_feat_grad_fwdmode(model.neuconw.sdf_net, fc.sdf_cfg, pts)
    elif fc.grad_mode == "vjp":
        sdf, feat, grad = sdf_value_feat_grad(
            model.neuconw.sdf_net, fc.sdf_cfg, pts, act, create_graph=create_graph)
    else:
        raise ValueError(f"unknown SDF_GRAD_MODE {fc.grad_mode!r}")
    rgb = apply_color(model.neuconw.color_net, fc.color_cfg, fc.encode_a, pts, grad,
                      dirs, feat, a_embedded, act_dtype=act, n_samples=n_samples)
    return rgb, inv_s(model), sdf, grad


def field_rgb(model: NeuconWField, fc: FieldConfig, pts, dirs, a_embedded) -> torch.Tensor:
    """Colour probe for mesh vertex colouring (``neuconw.py:185-189``), with
    no autograd graph kept."""
    with torch.no_grad():
        rgb, _, _, _ = field_forward(model, fc, pts, dirs, a_embedded)
    return rgb


def field_background(model: NeuconWField, fc: FieldConfig, pts4, dirs, a_embedded,
                     n_samples=None):
    """Background NeRF at (N, 4) inverted-sphere coordinates; with
    bg_mode 'pallas' through the fused kernels (``neuconw.py:192-213``)."""
    a = a_embedded if fc.encode_a_bg else None
    if fc.bg_mode == "pallas":
        from ..ops.nerf_bg_fused import nerf_bg_kernel

        if n_samples is not None:
            dirs, a = _per_sample(dirs, n_samples), _per_sample(a, n_samples)
        return nerf_bg_kernel(model.nerf, fc.encode_a_bg, pts4, dirs, a, fc.act_dtype)
    if fc.bg_mode != "xla":
        raise ValueError(f"unknown bg_mode {fc.bg_mode!r}")
    return apply_nerf_bg(model.nerf, fc.encode_a_bg, pts4, dirs, a,
                         act_dtype=act_dtype_of(fc.act_dtype), n_samples=n_samples)
