"""SDF geometry network (``neuralrecon_w_tpu/models/sdf.py``).

PE(multires 6) -> 8 x 512 weight-normed Softplus(beta=100) MLP with a
skip at layer 4 ([h, pe] / sqrt 2; the layer before it shrinks its
output so the concat is d_hidden wide) -> [sdf | 512 feature]; sdf is
divided by ``scale``. Geometric (sphere) init, as the reference's
SDFNetwork (reference models/neuconw.py:183-296).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import WNLinear, layer_weight, pe_dim, positional_encoding, softplus_beta

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def act_dtype_of(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


def sdf_layer_dims(cfg) -> list:
    d_pe = pe_dim(cfg["d_in"], cfg["multires"]) if cfg["multires"] > 0 else cfg["d_in"]
    return [d_pe] + [cfg["d_hidden"]] * cfg["n_layers"] + [cfg["d_out"]]


def sdf_layer_shapes(cfg) -> list:
    """(d_in, d_out) per layer; the pre-skip layer's output is shrunk."""
    dims = sdf_layer_dims(cfg)
    skip_in = tuple(cfg["skip_in"])
    for s in skip_in:
        if dims[s] - dims[0] <= 0:
            raise ValueError(
                f"d_hidden ({dims[s]}) must exceed the PE input width "
                f"({dims[0]}) for the skip concat at layer {s}")
    return [
        (dims[l], dims[l + 1] - dims[0] if (l + 1) in skip_in else dims[l + 1])
        for l in range(len(dims) - 1)
    ]


class SDFNetwork(nn.Module):
    """Layers ``lin{L}``, named as the reference's ``sdf_net``."""

    def __init__(self, cfg: dict, device=None):
        super().__init__()
        lin = WNLinear if cfg["weight_norm"] else nn.Linear
        for l, (d_in, d_out) in enumerate(sdf_layer_shapes(cfg)):
            setattr(self, f"lin{l}", lin(d_in, d_out, device=device))
        self.n_layers = len(sdf_layer_shapes(cfg))

    def layer(self, l: int) -> nn.Module:
        return getattr(self, f"lin{l}")


@torch.no_grad()
def init_sdf_(net: SDFNetwork, cfg: dict, generator: torch.Generator) -> None:
    """Geometric init in place (``sdf.py:40-90``), drawn from ``generator``.

    The PE tail of the skip input (every PE channel past raw xyz) and of
    layer 0 is zeroed, so at init sdf(x) ~ |x| - bias."""
    dims = sdf_layer_dims(cfg)
    skip_in = tuple(cfg["skip_in"])
    n_layers = net.n_layers
    bias = float(cfg["bias"])
    inside_outside = bool(cfg["inside_outside"])
    multires = int(cfg["multires"])
    for l in range(n_layers):
        layer = net.layer(l)
        d_out, d_in = layer_weight(layer).shape
        dev = layer_weight(layer).device

        def normal(*shape):
            return torch.randn(*shape, generator=generator).to(dev)

        if cfg["geometric_init"]:
            if l == n_layers - 1:
                mean = math.sqrt(math.pi) / math.sqrt(d_in)
                mean = -mean if inside_outside else mean
                w = mean + 1e-4 * normal(d_out, d_in)
                b = torch.full((d_out,), bias if inside_outside else -bias, device=dev)
            else:
                w = normal(d_out, d_in) * (math.sqrt(2) / math.sqrt(d_out))
                if multires > 0 and l == 0:
                    w[:, 3:] = 0.0
                elif multires > 0 and l in skip_in:
                    w[:, -(dims[0] - 3):] = 0.0
                b = torch.zeros(d_out, device=dev)
        else:
            bound = 1.0 / math.sqrt(d_in)
            w = (torch.rand(d_out, d_in, generator=generator) * 2 - 1).to(dev) * bound
            b = (torch.rand(d_out, generator=generator) * 2 - 1).to(dev) * bound
        if isinstance(layer, WNLinear):
            layer.weight_v.copy_(w)
            layer.weight_g.copy_(torch.linalg.vector_norm(w, dim=1, keepdim=True))
        else:
            layer.weight.copy_(w)
        layer.bias.copy_(b)


def apply_sdf_split(net: SDFNetwork, cfg: dict, x: torch.Tensor,
                    act_dtype=torch.float32, with_feature: bool = True):
    """(..., 3) -> (sdf (..., 1) f32 (or f64), feature (..., d_out-1) in act_dtype
    or None) (``sdf.py:100-155``): the skip layer runs as two row-block
    products, the last layer as [sdf | feature] column blocks."""
    act = act_dtype_of(act_dtype)
    skip_in = tuple(cfg["skip_in"])
    scale = float(cfg["scale"])
    x = x * scale
    shape = x.shape[:-1]
    x = x.reshape(-1, cfg["d_in"])
    inputs = positional_encoding(x, cfg["multires"]) if cfg["multires"] > 0 else x
    inputs = inputs.to(act)

    h = inputs
    # made on the device (no host copy, which a captured step cannot hold)
    inv_sqrt2 = torch.full((), 1.0 / math.sqrt(2), dtype=act, device=x.device)
    for l in range(net.n_layers - 1):
        layer = net.layer(l)
        w = layer_weight(layer).to(act)
        b = layer.bias.to(act)
        if l in skip_in:
            d_h = h.shape[-1]
            h = (h @ w[:, :d_h].t() + inputs @ w[:, d_h:].t()) * inv_sqrt2 + b
        else:
            h = h @ w.t() + b
        h = softplus_beta(h, 100.0)
    last = net.layer(net.n_layers - 1)
    w = layer_weight(last).to(act)
    b = last.bias.to(act)
    # sdf in float32 (float64 stays float64, for the tests' exact references)
    sdf = (h @ w[:1].t() + b[:1]).to(torch.promote_types(act, torch.float32)) / scale
    feat = (h @ w[1:].t() + b[1:]) if with_feature else None
    return sdf.reshape(*shape, 1), (
        feat.reshape(*shape, feat.shape[-1]) if with_feature else None)


def sdf_value(net: SDFNetwork, cfg: dict, x: torch.Tensor, act_dtype=torch.float32):
    """Signed distance only, (..., 3) -> (...,)."""
    sdf, _ = apply_sdf_split(net, cfg, x, act_dtype, with_feature=False)
    return sdf[..., 0]


def sdf_value_feat_grad(net: SDFNetwork, cfg: dict, x: torch.Tensor,
                        act_dtype=torch.float32, create_graph: bool = False):
    """(sdf (...,), feature, d sdf / d x (..., 3)) in one forward and one
    reverse pass (``sdf.py:173-182``). Serving uses create_graph=False:
    the gradient is a value, and the returned tensors carry no graph."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True) if not x.requires_grad else x
        sdf, feat = apply_sdf_split(net, cfg, x, act_dtype)
        (grad,) = torch.autograd.grad(
            sdf, x, grad_outputs=torch.ones_like(sdf), create_graph=create_graph)
    if not create_graph:
        sdf, feat, grad = sdf.detach(), feat.detach(), grad.detach()
    return sdf[..., 0], feat, grad


def sdf_value_feat_grad_fwdmode(net: SDFNetwork, cfg: dict, x: torch.Tensor):
    """(sdf (...,), feature, d sdf / d x (..., 3)) by forward mode
    (``sdf.py:185-198``): one primal pass and three tangent passes, the
    unit tangents batched by ``torch.func.vmap`` over ``torch.func.jvp``.
    Training differentiates reverse over forward: the parameters stay
    ordinary autograd tensors inside the transform, so a loss on the
    tangents reaches them. The JAX function evaluates the net with
    ``apply_sdf``'s default float32 activations whatever the field's dtype,
    and so does this one: the feature is float32. Under ``torch.no_grad``
    (serving) nothing carries a graph."""
    from torch.func import jvp, vmap

    def f(pts):
        return apply_sdf_split(net, cfg, pts)

    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    tangents = eye.reshape(3, *([1] * (x.dim() - 1)), 3).expand(3, *x.shape)
    (sdf, feat), (d_sdf, _) = vmap(lambda t: jvp(f, (x,), (t,)), out_dims=((None, None), 0))(
        tangents)
    return sdf[..., 0], feat, torch.movedim(d_sdf[..., 0], 0, -1)
