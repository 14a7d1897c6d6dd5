"""Shared building blocks (``neuralrecon_w_tpu/models/layers.py``).

Weights keep torch's (d_out, d_in) layout, so the state-dict names and
shapes are the reference checkpoint's: a weight-normed layer holds
``weight_v`` (d_out, d_in), ``weight_g`` (d_out, 1) and ``bias``, with the
effective weight ``v * g / max(||v||_row, 1e-12)`` (``torch.nn.utils.
weight_norm`` with dim=0; the JAX package stores the transpose).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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


def layer_weight(layer: nn.Module) -> torch.Tensor:
    """(d_out, d_in) weight of a plain or weight-normed linear."""
    if isinstance(layer, WNLinear):
        return layer.effective_weight()
    return layer.weight


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
