"""Shared building blocks (``neuralrecon_w_tpu/models/layers.py``).

Weights keep torch's (d_out, d_in) layout, so the state-dict names and
shapes are the reference checkpoint's: a weight-normed layer holds
``weight_v`` (d_out, d_in), ``weight_g`` (d_out, 1) and ``bias``, with the
effective weight ``v * g / max(||v||_row, 1e-12)`` (``torch.nn.utils.
weight_norm`` with dim=0; the JAX package stores the transpose).

Every linear of the field networks runs through ``linear``, which issues
one product a layer (two where a per-ray block is taken once a ray, one
per output block where ``outs`` splits the output) with
the bias in the product's epilogue (``F.linear``: cuBLASLt adds it before
the one rounding). The JAX package never concatenates a layer's input: it
runs a product per input block over the weight's column slices and adds
them, which XLA fuses on the TPU. On a GPU those slices and the widths of
the field (the encodings' 39, 27 and 84, the SDF's 473, the colour's 134
and the heads' 587 and 331) give the library operands whose base or
leading dimension is not a multiple of 16 bytes, which it runs on kernels
of 1-element loads, and every partial sum and bias is one more pass over
the activations. So the port writes a layer's input blocks into one buffer
and pads its width with zero columns to a multiple of ``align_of(dtype)``
elements (8 in bf16, 4 in f32), pads the effective weight once a call with
the matching zero columns, and pads the output width with zero rows (a
zero bias), split off the result unless the caller keeps them. An input
made wider by its producer (``positional_encoding(..., width=)``, a hidden
activation kept ``padded``) meets zero weight columns too. The
parameters, their names and shapes do not change. ``linear.aligned`` and
``linear.fallback`` count the products at issue (a graph's replays are
not counted): aligned, or not padded (a split layer's blocks). On a card a
float32 product runs on K15 (``ops/split_tf32``: three TF32 tensor-core
products a float32 one, float32-accurate, its backward and double backward
products of the same kernel), counted in ``linear.split_tf32``; bf16
products stay on ``F.linear``.

A layer split over a model axis (``parallel/tensor.py``) holds its rank's
block and runs through ``tp_linear``: column (the output dim split)
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

from ..ops.split_tf32 import split_tf32_linear
from ..parallel import tensor as tp


def positional_encoding(x: torch.Tensor, n_freqs: int, include_input: bool = True,
                        width=None) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{n-1} x), cos(2^{n-1} x)],
    with zero columns after it up to ``width`` where that is wider."""
    feats = [x] if include_input or n_freqs <= 0 else []
    for i in range(max(n_freqs, 0)):
        feats.append(torch.sin(x * (2.0 ** i)))
        feats.append(torch.cos(x * (2.0 ** i)))
    d = sum(f.shape[-1] for f in feats)
    if width is not None and width > d:
        feats.append(x.new_zeros(*x.shape[:-1], width - d))
    return feats[0] if len(feats) == 1 else torch.cat(feats, dim=-1)


def pe_dim(d_in: int, n_freqs: int, include_input: bool = True) -> int:
    return d_in * ((1 if include_input else 0) + 2 * n_freqs)


def align_of(dtype) -> int:
    """Elements of ``dtype`` in 16 bytes: the multiple a product's widths,
    leading dimensions and offsets take (8 in bf16, 4 in f32)."""
    return max(1, 16 // dtype.itemsize)


def aligned_width(k: int, dtype) -> int:
    """``k`` rounded up to a multiple of ``align_of(dtype)``."""
    a = align_of(dtype)
    return -(-k // a) * a


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


def weight_bias(layer, dtype=None, norm_first: bool = False, scale=None):
    """(weight (d_out, d_in), bias) of a linear in ``dtype``, as it computes
    on this rank: a whole layer's own, a (weight, bias) pair as given, a
    split layer's block of the weight and the bias's block (column) or the
    whole bias (row). The JAX package's colour and background nets cast v
    and g before the weight norm; its SDF net takes the norm in the
    parameters' dtype and casts the weight (``norm_first``). ``scale`` (a
    whole layer's) multiplies the weight before that cast."""
    scaled = (lambda w: w) if scale is None else (lambda w: w * scale)  # noqa: E731
    if isinstance(layer, tuple):
        return _cast(scaled(layer[0]), dtype), _cast(layer[1], dtype)
    b = _cast(layer.bias, dtype)
    if not hasattr(layer, "weight_v"):
        return _cast(scaled(layer.weight), dtype), b
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
    return (_cast(scaled(w), dtype) if norm_first else scaled(w)), b


def per_sample(t, n_samples):
    """Per-ray rows (R, d) repeated for each of a ray's n_samples samples
    (autograd sums their cotangents back per ray); t itself when
    n_samples is None."""
    if t is None or n_samples is None:
        return t
    return t[:, None, :].expand(t.shape[0], n_samples, t.shape[-1]).reshape(-1, t.shape[-1])


def _aligned(t: torch.Tensor) -> bool:
    """Whether a product operand's base and leading dimension are multiples
    of 16 bytes (a dimension of 1 has no leading dimension to align)."""
    a = align_of(t.dtype)
    if t.storage_offset() % a:
        return False
    if t.dim() < 2 or 1 in t.shape[-2:]:
        return True
    s0, s1 = t.stride(-2), t.stride(-1)
    ld = s0 if s1 == 1 else s1 if s0 == 1 else 1
    return ld % a == 0


def _tick(aligned: bool, n: int = 1) -> None:
    if aligned:
        linear.aligned += n
    else:
        linear.fallback += n


def _partial_products(weight: torch.Tensor, parts) -> torch.Tensor:
    """A split layer's block over cat(parts, -1) as row-block partial
    products, without the concatenation (``layers.py:87-103``)."""
    acc = None
    off = 0
    for x in parts:
        k = x.shape[-1]
        y = x @ weight[:, off:off + k].t()
        acc = y if acc is None else acc + y
        off += k
    if off != weight.shape[1]:
        raise ValueError(f"parts cover {off} inputs, weight has {weight.shape[1]}")
    _tick(False, len(parts))
    return acc


def tp_linear(layer, x, dtype=None, scale=None, norm_first: bool = False):
    """A split linear over ``x`` (a tensor, or a tuple of the input's column
    blocks in order); ``scale`` multiplies the product before the bias.
    Every rank gets the whole output. Column: gather(copy(x) @ W_r.T +
    b_r), one product per block; row: reduce(split(x) @ W_r.T) + b over
    cat(x, -1). Its products are not padded: ``linear.fallback`` counts
    them."""
    s = tp.split_of(layer)
    w, b = weight_bias(layer, dtype, norm_first)
    parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    if s.kind == "col":
        acc = _partial_products(w, tuple(tp.copy(p, s.axis) for p in parts))
        if scale is not None:
            acc = acc * scale
        return tp.gather(acc + b, s.axis)
    xs = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
    acc = tp.reduce(tp.split(xs, s.axis) @ w.t(), s.axis)
    _tick(False)
    if scale is not None:
        acc = acc * scale
    return acc + b


def linear(layer, x, dtype=None, *, scale=None, n_samples=None, outs=None, widths=None,
           padded: bool = False, norm_first: bool = False):
    """``layer`` over ``x``, or over cat(x, -1) for a tuple of the input's
    column blocks, in ``dtype``: one product over one aligned operand, the
    bias in its epilogue. ``layer`` is a linear (plain or weight-normed,
    whole or split over a model axis) or a whole (weight, bias) pair;
    ``norm_first`` as ``weight_bias``.

      * ``widths``, the layer's input columns each block carries (default:
        a lone block the layer's width, a tuple's blocks their own); a
        block wider than that carries padding in its last columns (any
        finite values), met by zero weight columns;
      * ``padded`` returns the output with its padding columns (zero: zero
        weight rows, zero bias), as wide as a product operand must be;
      * ``scale`` (a float) multiplies the product before the bias: a whole
        layer's weight takes it before its cast (the SDF skip's 1 / sqrt 2);
      * with ``n_samples``, the blocks after the first hold a row per ray
        (N / n_samples rows): their product, with the bias, is taken once
        per ray and broadcast to the ray's samples;
      * ``outs``, slices of the output features: a tuple of those blocks,
        each its own product over its rows (an SDF sweep computes no
        feature; in training the input gradient of the sdf block alone
        stays a product of 8 rows, where one product over [sdf | feature]
        would take a dense one over every row).

    A split layer runs through ``tp_linear`` over per-sample rows and its
    blocks without their padding, and ``outs`` slices its whole output
    after the collective."""
    parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    s = None if isinstance(layer, tuple) else tp.split_of(layer)
    if s is not None:
        if widths is None and len(parts) == 1:
            w = layer.weight_v if hasattr(layer, "weight_v") else layer.weight
            widths = (w.shape[1] * (s.axis.n if s.kind == "row" else 1),)
        if widths is not None:
            parts = tuple(p[..., :n] for p, n in zip(parts, widths))
        parts = parts[:1] + tuple(per_sample(p, n_samples) for p in parts[1:])
        y = tp_linear(layer, parts, dtype, scale, norm_first)
        return y if outs is None else tuple(y[..., o] for o in outs)
    w, b = weight_bias(layer, dtype, norm_first, scale)
    if widths is None:
        widths = (w.shape[1],) if len(parts) == 1 else tuple(p.shape[-1] for p in parts)
    if outs is not None:
        return tuple(_unpadded(_product(parts, widths, w[o], b[o]), len(range(
            *o.indices(w.shape[0])))) for o in outs)
    if n_samples is None:
        y = _product(parts, widths, w, b)
    else:
        d = widths[0]
        z = _product(parts[:1], widths[:1], w[:, :d], None)
        z_ray = _product(parts[1:], widths[1:], w[:, d:], b)
        y = (z.reshape(-1, n_samples, z.shape[-1]) + z_ray[:, None, :]).reshape(z.shape)
    return y if padded else _unpadded(y, w.shape[0])


def _unpadded(y, d_out):
    """The first ``d_out`` columns of a padded output (split off, so that
    the backward writes the padded cotangent in one pass)."""
    return y if y.shape[-1] == d_out else y.split([d_out, y.shape[-1] - d_out], -1)[0]


linear.aligned = 0
linear.fallback = 0
linear.split_tf32 = 0


def _split_route(x: torch.Tensor) -> bool:
    """Whether a product over ``x`` runs on K15 (``ops/split_tf32``): a
    float32 operand on a card, where the library's float32 products run on
    the FMA pipes and TF32 alone misses float32's accuracy."""
    return x.dtype == torch.float32 and x.is_cuda


def _product(parts, widths, w, b):
    """cat(parts, -1) @ w.T + b as one product, padded: the blocks written
    into one buffer whose width is a multiple of 16 bytes (zero columns
    after them where needed), ``w`` laid out to match with zero columns
    where a block carries padding, zero rows and a zero bias up to an
    aligned output width, the bias in the epilogue. A float32 product on a
    card runs on K15 (``_split_route``), counted in ``linear.split_tf32``;
    bf16 and CPU products on ``F.linear``."""
    d_out, k = w.shape
    if len(widths) != len(parts) or sum(widths) != k or any(
            p.shape[-1] < n for p, n in zip(parts, widths)):
        raise ValueError(f"blocks of widths {[p.shape[-1] for p in parts]} carrying "
                         f"{list(widths)} columns for a weight of {k}")
    x = parts[0]
    width = sum(p.shape[-1] for p in parts)
    pad = aligned_width(width, x.dtype) - width
    if len(parts) > 1 or pad or not _aligned(x):
        x = torch.cat(parts + ((x.new_zeros(*x.shape[:-1], pad),) if pad else ()), -1)
    rows = aligned_width(d_out, w.dtype)
    if any(p.shape[-1] > n for p, n in zip(parts[:-1], widths[:-1])):
        # zero columns after each block's own; F.pad below adds the last's
        cols, off = [], 0
        for p, n in zip(parts[:-1], widths[:-1]):
            cols += [w[:, off:off + n], w.new_zeros(d_out, p.shape[-1] - n)]
            off += n
        w = torch.cat(cols + [w[:, off:]], 1)
    if (rows, x.shape[-1]) != tuple(w.shape):
        w = F.pad(w, (0, x.shape[-1] - w.shape[1], 0, rows - d_out))
        b = None if b is None else F.pad(b, (0, rows - d_out))
    elif not (w.is_contiguous() and _aligned(w)):
        w = w.clone(memory_format=torch.contiguous_format)
    if b is not None and b.storage_offset() % align_of(b.dtype):
        b = b.clone()  # the epilogue's bias vector, aligned
    _tick(_aligned(x) and _aligned(w))
    if _split_route(x):
        linear.split_tf32 += 1
        return split_tf32_linear(x, w, b)
    return F.linear(x, w, b)
