"""Neuralangelo's SDF net (Li et al., CVPR 2023; NVlabs/neuralangelo,
``projects/neuralangelo/configs/base.yaml``): the second kind of SDF net,
selected by ``SDF_CONFIG.type: hashgrid`` (``config.HASH_SDF_CONFIG``).

[x, hash encoding of x] (3 + L F wide, ``ops/hash_grid.py``) -> n_layers x
d_hidden weight-normed Softplus(beta=100) MLP -> [sdf | d_out - 1 feature],
with the geometric init (the encoding columns of layer 0 zeroed, the
output bias -bias, so sdf(x) ~ |x| - bias) and the table drawn from
U(+-init_table). Its gradient is numerical: four tetrahedral taps at e =
eps / sqrt 3, eps = 1 / N of the last active level, grad = sum k_i f_i /
(4 e), and the Laplacian (sum f_i / 2 - 2 f(x)) / e^2 for the curvature
loss; a sample costs the point's and its taps' five evaluations, batched
as one encoding and one product a layer, and training differentiates them
once (no double backward). The coarse-to-fine schedule is device state:
``active`` (int32), the levels in use, which the kernels read, set from
the step by ``set_step`` (eagerly, or inside a captured step from the
step's device counter), and eps and the curvature weight's decay follow
it on the device, so one CUDA graph serves the whole progression.

Every product is float32 (TF32 off): the taps' differences at 16 levels
are ~e |grad f| ~ 2.8e-4, which bfloat16 (an sdf of ~0.5 to ~4e-3) or
TF32's 10-bit operands would turn into noise.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.hash_grid import encode, grid_spec
from ..tracing import span
from .layers import WNLinear, layer_weight, linear, softplus_beta

# the tetrahedral taps' directions (Neuralangelo's k1 ... k4)
TAPS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))


def hash_sdf_dims(cfg: dict) -> list:
    spec = grid_spec(cfg)
    return [cfg["d_in"] + spec.width] + [cfg["d_hidden"]] * cfg["n_layers"] + [cfg["d_out"]]


class HashSDFNetwork(nn.Module):
    """The table ``table`` (entries, F) and layers ``lin{L}``; the
    schedule's device state in buffers that a checkpoint does not keep;
    ``models/sdf.SDFNetwork``'s interface. It runs only as 'vjp' in float32:
    the K-kernel modes (and 'fwd') compute the MLP net's autograd gradient,
    and bfloat16 cannot resolve the taps' differences."""

    def __init__(self, cfg: dict, device=None, grad_mode: str = "vjp",
                 act_dtype: str = "float32"):
        if grad_mode != "vjp":
            raise ValueError(f"SDF_CONFIG.type hashgrid takes its gradient from its taps: "
                             f"TPU.SDF_GRAD_MODE must be 'vjp', not {grad_mode!r}")
        if act_dtype != "float32":
            raise ValueError(f"SDF_CONFIG.type hashgrid runs in float32 (its taps' differences "
                             f"are below bfloat16's resolution): TPU.FIELD_DTYPE must be "
                             f"'float32', not {act_dtype!r}")
        super().__init__()
        self.cfg = dict(cfg)
        self.spec = spec = grid_spec(cfg)
        self.table = nn.Parameter(torch.empty(spec.n_entries, spec.features, device=device))
        lin = WNLinear if cfg["weight_norm"] else nn.Linear
        dims = hash_sdf_dims(cfg)
        for l in range(len(dims) - 1):
            setattr(self, f"lin{l}", lin(dims[l], dims[l + 1], device=device))
        self.n_layers = len(dims) - 1
        self.init_active = max(1, min(int(cfg["init_active"]), spec.levels))
        self.level_every = int(cfg["level_every"])
        growth = (spec.res[-1] / spec.res[0]) ** (1.0 / max(spec.levels - 1, 1))
        self.register_buffer("active", torch.tensor(spec.levels, dtype=torch.int32,
                                                    device=device), persistent=False)
        self.register_buffer("inv_res", torch.tensor([1.0 / n for n in spec.res],
                                                     dtype=torch.float32, device=device),
                             persistent=False)
        # the curvature weight's decay at each active count: growth^-(added levels)
        self.register_buffer("curv_decay", torch.tensor(
            [growth ** -max(a - self.init_active, 0) for a in range(spec.levels + 1)],
            dtype=torch.float32, device=device), persistent=False)
        self.register_buffer("taps", torch.tensor(TAPS, dtype=torch.float32, device=device),
                             persistent=False)

    def layer(self, l: int) -> nn.Module:
        return getattr(self, f"lin{l}")

    def levels_at(self, step: int) -> int:
        """The active levels at a step: init_active, one more every
        level_every steps, at most all of them."""
        if self.level_every <= 0:
            return self.spec.levels
        return min(self.spec.levels, self.init_active + int(step) // self.level_every)

    @torch.no_grad()
    def set_step(self, step) -> None:
        """The schedule at ``step``: a host int, or a 0-d device tensor (a
        captured step's counter), read on the device."""
        if not isinstance(step, torch.Tensor):
            self.active.fill_(self.levels_at(step))
        elif self.level_every <= 0:
            self.active.fill_(self.spec.levels)
        else:
            added = torch.div(step, self.level_every, rounding_mode="floor")
            self.active.copy_(torch.clamp(added + self.init_active, max=self.spec.levels))

    def tap_distance(self) -> torch.Tensor:
        """e = eps / sqrt 3, eps = 1 / N of the last active level (0-d)."""
        i = (self.active.long() - 1).clamp(min=0).reshape(1)
        return self.inv_res.index_select(0, i).reshape(()) / math.sqrt(3.0)

    def curvature_decay(self) -> torch.Tensor:
        """growth^-(levels added since init_active) at the active count (0-d)."""
        return self.curv_decay.index_select(0, self.active.long().reshape(1)).reshape(())

    def sdf(self, x: torch.Tensor, act_dtype="float32") -> torch.Tensor:
        """Signed distance, (..., 3) -> (...,) float32, whatever ``act_dtype``."""
        h, d_h = _hidden(self, x.reshape(-1, 3).float())
        return _last(self, h, d_h, slice(0, 1))[:, 0].reshape(x.shape[:-1])

    def sdf_fn(self, act_dtype="float32", plain: bool = False):
        """The sampler's and the sweeps' SDF: ``sdf`` (K13 and its products)."""
        return self.sdf

    def sdf_feat_grad(self, x: torch.Tensor, grad_mode: str = "vjp", act_dtype="float32",
                      create_graph: bool = False, laplacian: bool = False):
        """``hash_sdf_feat_grad``, the Laplacian where asked with autograd on
        (training's curvature term); any ``grad_mode`` runs the taps."""
        return hash_sdf_feat_grad(self, x, laplacian and torch.is_grad_enabled())

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """Neuralangelo's init in place, drawn from ``generator``: the table
        U(+-init_table); the geometric init of the layers (N(0, 2 / d_out)
        weights with layer 0's encoding columns zeroed, zero biases; the last
        layer sqrt(pi / d_in) + N(0, 1e-8), bias -bias)."""
        cfg, dev = self.cfg, self.table.device
        lim = float(cfg["init_table"])
        self.table.copy_(((torch.rand(self.table.shape, generator=generator) * 2 - 1) * lim)
                         .to(dev))
        bias = float(cfg["bias"])
        inside_outside = bool(cfg["inside_outside"])
        for l in range(self.n_layers):
            layer = self.layer(l)
            d_out, d_in = layer_weight(layer).shape
            z = torch.randn(d_out, d_in, generator=generator).to(dev)
            if l == self.n_layers - 1:
                mean = math.sqrt(math.pi) / math.sqrt(d_in)
                w = (-mean if inside_outside else mean) + 1e-4 * z
                b = torch.full((d_out,), bias if inside_outside else -bias, device=dev)
            else:
                w = z * (math.sqrt(2) / math.sqrt(d_out))
                if l == 0:
                    w[:, cfg["d_in"]:] = 0.0
                b = torch.zeros(d_out, device=dev)
            if isinstance(layer, WNLinear):
                layer.weight_v.copy_(w)
                layer.weight_g.copy_(torch.linalg.vector_norm(w, dim=1, keepdim=True))
            else:
                layer.weight.copy_(w)
            layer.bias.copy_(b)


def _hidden(net: HashSDFNetwork, x: torch.Tensor):
    """(P, 3) float32 -> the last hidden activation (P, d_hidden) and its
    width."""
    enc = encode(x, net.table, net.spec, net.active)
    f32 = torch.float32
    h = linear(net.lin0, (x, enc), f32, widths=(x.shape[-1], enc.shape[-1]), padded=True,
               norm_first=True)
    d_h = net.lin0.bias.shape[0]
    h = softplus_beta(h, 100.0)
    for l in range(1, net.n_layers - 1):
        layer = net.layer(l)
        h = softplus_beta(linear(layer, h, f32, widths=(d_h,), padded=True, norm_first=True),
                          100.0)
        d_h = layer.bias.shape[0]
    return h, d_h


def _last(net: HashSDFNetwork, h, d_h, out: slice):
    return linear(net.layer(net.n_layers - 1), h, torch.float32, outs=(out,), widths=(d_h,),
                  norm_first=True)[0]


def hash_sdf_feat_grad(net: HashSDFNetwork, x: torch.Tensor, laplacian: bool = False):
    """(sdf (P,), feature (P, d_out - 1), numerical gradient (P, 3),
    Laplacian (P,) or None) at (P, 3) points: the point and its four taps
    evaluated as one batch, the feature at the point alone."""
    with span("field.taps", x.device):
        x = x.reshape(-1, 3).float()
        p = x.shape[0]
        e = net.tap_distance()
        taps = (x[None, :, :] + e * net.taps[:, None, :]).reshape(-1, 3)
        h, d_h = _hidden(net, torch.cat([x, taps]))
        s = _last(net, h, d_h, slice(0, 1))[:, 0]
        feat = _last(net, h[:p], d_h, slice(1, None))
        f0, f = s[:p], s[p:].reshape(4, p)
        grad = (f[:, :, None] * net.taps[:, None, :]).sum(0) / (4.0 * e)
        lap = (f.sum(0) * 0.5 - 2.0 * f0) / (e * e) if laplacian else None
    return f0, feat, grad, lap
