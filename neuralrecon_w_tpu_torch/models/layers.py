"""Shared building blocks (``neuralrecon_w_tpu/models/layers.py``).

Weights keep torch's (d_out, d_in) layout, so the state-dict names and
shapes are the reference checkpoint's: a weight-normed layer holds
``weight_v`` (d_out, d_in), ``weight_g`` (d_out, 1) and ``bias``, with the
effective weight ``v * g / max(||v||_row, 1e-12)`` (``torch.nn.utils.
weight_norm`` with dim=0; the JAX package stores the transpose).

Every linear of the field networks runs through ``linear``. A layer split
over a model axis (``parallel/tensor.py``) holds its rank's block and runs
through ``tp_linear``: column (the output dim split)
``gather(copy(x) @ W_r.T + b_r)``, row (the input dim split)
``reduce(split(x) @ W_r.T) + b``, the bias added once after the reduce,
a row split's weight norm summing its squares over the ranks.
``layer_weight`` and ``layer_bias`` give a layer's whole weight and bias,
a split one's gathered (its gradient reaching this rank's block): the
kernels' packers take these, as XLA gathers the operands of a
``pallas_call`` that has no sharding rule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor as tp


def positional_encoding(x: torch.Tensor, n_freqs: int, include_input: bool = True) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{n-1} x), cos(2^{n-1} x)]."""
    if n_freqs <= 0:
        return x
    feats = [x] if include_input else []
    for i in range(n_freqs):
        feats.append(torch.sin(x * (2.0 ** i)))
        feats.append(torch.cos(x * (2.0 ** i)))
    return torch.cat(feats, dim=-1)


def pe_dim(d_in: int, n_freqs: int, include_input: bool = True) -> int:
    return d_in * ((1 if include_input else 0) + 2 * n_freqs)


def softplus_beta(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """Softplus with sharpness beta and torch's threshold 20 (the
    reference's ``nn.Softplus(beta=100)``); above the threshold it is
    the identity, within 1e-11 of the JAX package's logaddexp form."""
    return F.softplus(x, beta=beta, threshold=20.0)


def wn_weight(weight_v: torch.Tensor, weight_g: torch.Tensor) -> torch.Tensor:
    """Effective weight of a weight-normed layer, (d_out, d_in)."""
    norm = torch.linalg.vector_norm(weight_v, dim=1, keepdim=True)
    return weight_v * (weight_g / torch.clamp(norm, min=1e-12))


class WNLinear(nn.Module):
    """Weight-normed linear layer with the reference's parameter names."""

    def __init__(self, d_in: int, d_out: int, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.weight_v = nn.Parameter(torch.empty(d_out, d_in, **kw))
        self.weight_g = nn.Parameter(torch.empty(d_out, 1, **kw))
        self.bias = nn.Parameter(torch.empty(d_out, **kw))

    @property
    def in_features(self) -> int:
        return self.weight_v.shape[1]

    def effective_weight(self) -> torch.Tensor:
        return wn_weight(self.weight_v, self.weight_g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.effective_weight(), self.bias)


def _cast(t, dtype):
    return t if dtype is None else t.to(dtype)


def layer_weight(layer: nn.Module) -> torch.Tensor:
    """(d_out, d_in) weight of a plain or weight-normed linear; a split
    layer's whole weight, gathered."""
    s = tp.split_of(layer)
    if s is not None:
        if not hasattr(layer, "weight_v"):
            return tp.gather(layer.weight, s.axis, s.dim)
        g = tp.gather(layer.weight_g, s.axis, 0) if s.kind == "col" else layer.weight_g
        return wn_weight(tp.gather(layer.weight_v, s.axis, s.dim), g)
    if isinstance(layer, WNLinear):
        return layer.effective_weight()
    return layer.weight


def layer_bias(layer: nn.Module) -> torch.Tensor:
    """A linear's bias; a split layer's whole bias, gathered (a row split's
    is whole already)."""
    s = tp.split_of(layer)
    return layer.bias if s is None or s.kind == "row" else tp.gather(layer.bias, s.axis, 0)


def weight_bias(layer, dtype=None, norm_first: bool = False):
    """(weight (d_out, d_in), bias) of a linear in ``dtype``, as it computes
    on this rank: a whole layer's own, a (weight, bias) pair as given, a
    split layer's block of the weight and the bias's block (column) or the
    whole bias (row). The JAX package's colour and background nets cast v
    and g before the weight norm; its SDF net takes the norm in the
    parameters' dtype and casts the weight (``norm_first``)."""
    if isinstance(layer, tuple):
        return tuple(_cast(t, dtype) for t in layer)
    b = _cast(layer.bias, dtype)
    if not hasattr(layer, "weight_v"):
        return _cast(layer.weight, dtype), b
    v, g = (layer.weight_v, layer.weight_g) if norm_first else (
        _cast(layer.weight_v, dtype), _cast(layer.weight_g, dtype))
    s = tp.split_of(layer)
    if s is None or s.kind == "col":
        w = wn_weight(v, g)
    else:
        # every rank's weight block depends on the whole norm and on g: both
        # enter through copy, whose backward sums the ranks' parts
        sq = tp.copy(tp.reduce(torch.sum(v * v, dim=1, keepdim=True), s.axis), s.axis)
        norm = torch.sqrt(torch.clamp(sq, min=1e-24))  # = max(||v||, 1e-12)
        w = v * (tp.copy(g, s.axis) / norm)
    return (_cast(w, dtype) if norm_first else w), b


def per_sample(t, n_samples):
    """Per-ray rows (R, d) repeated for each of a ray's n_samples samples
    (autograd sums their cotangents back per ray); t itself when
    n_samples is None."""
    if t is None or n_samples is None:
        return t
    return t[:, None, :].expand(t.shape[0], n_samples, t.shape[-1]).reshape(-1, t.shape[-1])


def apply_linear_parts(weight: torch.Tensor, bias, parts) -> torch.Tensor:
    """Linear layer over cat(parts, -1) as row-block partial products,
    without materialising the concatenation (``layers.py:87-103``)."""
    acc = bias
    off = 0
    for x in parts:
        k = x.shape[-1]
        y = x @ weight[:, off:off + k].t()
        acc = y if acc is None else acc + y
        off += k
    if off != weight.shape[1]:
        raise ValueError(f"parts cover {off} inputs, weight has {weight.shape[1]}")
    return acc


def tp_linear(layer, x, dtype=None, scale=None, norm_first: bool = False):
    """A split linear over ``x`` (a tensor, or a tuple of the input's column
    blocks in order); ``scale`` multiplies the product before the bias.
    Every rank gets the whole output. Column: gather(copy(x) @ W_r.T +
    b_r), one product per block; row: reduce(split(x) @ W_r.T) + b over
    cat(x, -1)."""
    s = tp.split_of(layer)
    w, b = weight_bias(layer, dtype, norm_first)
    parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    if s.kind == "col":
        acc = apply_linear_parts(w, None, tuple(tp.copy(p, s.axis) for p in parts))
        if scale is not None:
            acc = acc * scale
        return tp.gather(acc + b, s.axis)
    xs = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
    acc = tp.reduce(tp.split(xs, s.axis) @ w.t(), s.axis)
    if scale is not None:
        acc = acc * scale
    return acc + b


def linear(layer, x, dtype=None, *, scale=None, n_samples=None, outs=None,
           norm_first: bool = False):
    """``layer`` over ``x``, or over cat(x, -1) for a tuple of the input's
    column blocks, in ``dtype``, as row-block partial products without the
    concatenation. ``layer`` is a linear (plain or weight-normed, whole or
    split over a model axis) or a whole (weight, bias) pair; ``norm_first``
    as ``weight_bias``.

      * ``scale`` multiplies the product before the bias (the SDF skip's
        1 / sqrt 2);
      * with ``n_samples``, the blocks after the first hold a row per ray
        (N / n_samples rows): their product is taken once per ray and
        broadcast to the ray's samples;
      * ``outs``, slices of the output features: a tuple of those blocks,
        each its own product (an SDF sweep computes no feature).

    A split layer runs through ``tp_linear`` over per-sample rows, and
    ``outs`` slices its whole output after the collective."""
    parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    if not isinstance(layer, tuple) and tp.split_of(layer) is not None:
        parts = parts[:1] + tuple(per_sample(p, n_samples) for p in parts[1:])
        y = tp_linear(layer, parts, dtype, scale, norm_first)
        return y if outs is None else tuple(y[..., o] for o in outs)
    w, b = weight_bias(layer, dtype, norm_first)
    if outs is not None:
        return tuple(_whole_linear(w[o], b[o], parts, scale, n_samples) for o in outs)
    return _whole_linear(w, b, parts, scale, n_samples)


def _whole_linear(w, b, parts, scale, n_samples):
    if n_samples is not None:
        d = parts[0].shape[-1]
        z = parts[0] @ w[:, :d].t()
        z_ray = apply_linear_parts(w[:, d:], b, parts[1:])
        return (z.reshape(-1, n_samples, z.shape[-1]) + z_ray[:, None, :]).reshape(z.shape)
    if scale is None:
        return apply_linear_parts(w, b, parts)
    return apply_linear_parts(w, None, parts) * scale + b
