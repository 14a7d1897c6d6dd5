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
With ``SDF_CONFIG.type: hashgrid`` the SDF net is Neuralangelo's
(``models/hash_sdf.py``): its gradient is numerical (four taps, no
autograd gradient), ``field_forward`` can give its Laplacian, and it runs
only as 'vjp' in float32 (any other mode or dtype raises). ``NeuconWCore``
alone picks the net's kind: both answer ``models/sdf.SDFNetwork``'s calls.
``TPU.FUSED_BG`` (``bg_mode`` 'pallas') sends the background through the
fused NeRF++ kernels K8 / K9 (``ops/nerf_bg_fused.py``).

Gradient-free colour probes go through kernel 3's port instead: mesh
vertex colouring (``parallel/sweep.sharded_rgb_sweep``) calls
``ops/field_forward.fused_field_forward`` (K6, ``csrc/field_fwd.cu``)
where ``colours_by_k6``, and ``field_rgb`` here otherwise.

``NeuconWField`` is built on the card unless the caller names a device
(``device.default_device``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import FieldConfig
from ..device import default_device
from .color import RenderingNetwork, apply_color, init_color_
from .hash_sdf import HashSDFNetwork
from .layers import per_sample
from .nerf_bg import NeRF, apply_nerf_bg, init_nerf_bg_
from .sdf import SDFNetwork, act_dtype_of


class SingleVarianceNetwork(nn.Module):
    def __init__(self, init_val: float, device=None):
        super().__init__()
        self.variance = nn.Parameter(torch.tensor(float(init_val), device=device))


class NeuconWCore(nn.Module):
    def __init__(self, fc: FieldConfig, device=None):
        super().__init__()
        # the SDF net's kind is decided here, from SDF_CONFIG.type; callers ask the net
        if fc.sdf_cfg.get("type") == "hashgrid":
            self.sdf_net = HashSDFNetwork(fc.sdf_cfg, device, fc.grad_mode, fc.act_dtype)
        else:
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

    def set_step(self, step) -> None:
        """The field at a training step (a host int, or a captured step's 0-d
        device counter): a hash-grid net's active levels; the MLP net's none."""
        self.neuconw.sdf_net.set_step(step)

    def curvature_decay(self):
        """The curvature weight's factor at the field's state (a 0-d device
        tensor), or None where the SDF net has no Laplacian."""
        return self.neuconw.sdf_net.curvature_decay()


def init_field(fc: FieldConfig, generator: torch.Generator, device=None) -> NeuconWField:
    """Fresh field on ``device`` (default: the card) with the JAX package's
    initialisation (``models/neuconw.py:89-99``): N(0, 1) appearance table,
    the SDF net's own init (geometric), torch-default linears elsewhere,
    variance = S_CONFIG.init_val. The numbers differ from jax.random's; the
    distributions are the same."""
    model = NeuconWField(fc, device)
    table = model.embedding_a.weight
    with torch.no_grad():
        table.copy_(torch.randn(fc.n_vocab, fc.n_a, generator=generator).to(table.device))
    model.neuconw.sdf_net.init_(generator)
    init_color_(model.neuconw.color_net, generator)
    init_nerf_bg_(model.nerf, generator)
    return model


def inv_s(model: NeuconWField) -> torch.Tensor:
    """exp(10 * variance), clamped to [1e-6, 1e6]."""
    return torch.clamp(torch.exp(model.neuconw.deviation_network.variance * 10.0), 1e-6, 1e6)


def colours_by_k6(model: NeuconWField, fc: FieldConfig) -> bool:
    """Whether K6 (``ops/field_forward.fused_field_forward``) colours the
    field: the MLP net with an appearance code."""
    return fc.encode_a and isinstance(model.neuconw.sdf_net, SDFNetwork)


def field_sdf(model: NeuconWField, fc: FieldConfig, pts: torch.Tensor) -> torch.Tensor:
    """SDF probe, (..., 3) -> (...,)."""
    return model.neuconw.sdf_net.sdf(pts, fc.act_dtype)


def field_forward(model: NeuconWField, fc: FieldConfig, pts, dirs, a_embedded,
                  n_samples=None, create_graph: bool = False, laplacian: bool = False):
    """Foreground field at flattened samples: rgb (N, 3), inv_s, sdf
    (N,), gradients (N, 3) and the SDF's Laplacian (N,), which only a
    hash-grid net asked for it (``laplacian``) with autograd on gives
    (training's curvature term; else None).
    dirs / a_embedded are per ray when n_samples is set
    (``neuconw.py:117-182``). create_graph keeps the 'vjp' and 'fwd' modes'
    sdf, feature and gradient in the autograd graph, as training needs; the
    kernel modes and the hash-grid net's taps are always differentiable
    (once)."""
    if fc.grad_mode == "pallas_field":
        # the fused kernels take per-sample dirs and a (neuconw.py:132-149)
        from ..ops.field_train import field_rgb_sdf_grad_kernel

        dirs, a_embedded = per_sample(dirs, n_samples), per_sample(a_embedded, n_samples)
        rgb, sdf, grad = field_rgb_sdf_grad_kernel(model, fc, pts, dirs, a_embedded)
        return rgb, inv_s(model), sdf, grad, None
    sdf, feat, grad, lap = model.neuconw.sdf_net.sdf_feat_grad(
        pts, fc.grad_mode, fc.act_dtype, create_graph, laplacian)
    rgb = apply_color(model.neuconw.color_net, fc.color_cfg, fc.encode_a, pts, grad,
                      dirs, feat, a_embedded, act_dtype=act_dtype_of(fc.act_dtype),
                      n_samples=n_samples)
    return rgb, inv_s(model), sdf, grad, lap


def field_rgb(model: NeuconWField, fc: FieldConfig, pts, dirs, a_embedded) -> torch.Tensor:
    """Colour probe for mesh vertex colouring (``neuconw.py:185-189``), with
    no autograd graph kept."""
    with torch.no_grad():
        rgb = field_forward(model, fc, pts, dirs, a_embedded)[0]
    return rgb


def field_background(model: NeuconWField, fc: FieldConfig, pts4, dirs, a_embedded,
                     n_samples=None):
    """Background NeRF at (N, 4) inverted-sphere coordinates; with
    bg_mode 'pallas' through the fused kernels (``neuconw.py:192-213``)."""
    a = a_embedded if fc.encode_a_bg else None
    if fc.bg_mode == "pallas":
        from ..ops.nerf_bg_fused import nerf_bg_kernel

        dirs, a = per_sample(dirs, n_samples), per_sample(a, n_samples)
        return nerf_bg_kernel(model.nerf, fc.encode_a_bg, pts4, dirs, a, fc.act_dtype)
    if fc.bg_mode != "xla":
        raise ValueError(f"unknown bg_mode {fc.bg_mode!r}")
    return apply_nerf_bg(model.nerf, fc.encode_a_bg, pts4, dirs, a,
                         act_dtype=act_dtype_of(fc.act_dtype), n_samples=n_samples)
