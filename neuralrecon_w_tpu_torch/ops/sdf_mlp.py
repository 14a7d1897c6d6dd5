"""Fused SDF-MLP forward: Hopper kernel K1 (``csrc/sdf_mlp.cu``) and its
plain PyTorch version.

Port of ``neuralrecon_w_tpu/ops/pallas_mlp.py`` (``fused_sdf_head``,
``fused_field_sdf``) and of the MLP body ``_mlp_sdf`` of
``ops/pallas_sampler.py``: (N, 3) points -> (N,) sdf, with the positional
encoding computed in the kernel and only column 0 of the last layer
formed. ``pack_sdf_weights`` materialises the effective weight-normed
weights once per call, O(params), as the TPU packer does, without the
TPU's 128-lane padding: each layer is (round_up(N, 8), round_up(K, 16))
in the activation dtype, k contiguous, the last layer its column 0;
biases in f32.

The activation dtype is float32, or bfloat16 with every product summed
in f32 and the bias added in f32 (the Pallas sampler's
preferred_element_type dots). ``fused_field_sdf`` is always float32, as
``pallas_mlp.py`` is; the importance sampler passes its act_dtype.

``fused_sdf_head`` runs the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor; it has no other path.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..models.layers import layer_weight, positional_encoding
from ..models.sdf import SDFNetwork, act_dtype_of, sdf_layer_shapes
from .build import check, kernels, stream_handle

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


class PackedSDF(NamedTuple):
    w: torch.Tensor  # all layers' weights, flat, in the activation dtype
    b: torch.Tensor  # all layers' biases, flat, float32
    act: torch.dtype
    multires: int
    scale: float
    skip_mask: int  # bit l: layer l is fed [h, pe] / sqrt 2
    k: tuple  # input width per layer
    kpad: tuple  # weight row stride per layer (k rounded up to 16)
    n: tuple  # output width per layer (1 for the last: column 0)
    npad: tuple  # weight rows per layer (n rounded up to 8)
    woff: tuple
    boff: tuple

    def layer(self, l: int):
        """(W (N, K) in act dtype, b (N,) f32) views of layer l."""
        k, kpad, n, npad = self.k[l], self.kpad[l], self.n[l], self.npad[l]
        w = self.w[self.woff[l]:self.woff[l] + npad * kpad].view(npad, kpad)[:n, :k]
        return w, self.b[self.boff[l]:self.boff[l] + n]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@torch.no_grad()
def pack_sdf_weights(net: SDFNetwork, sdf_cfg_items: tuple, act_dtype="float32") -> PackedSDF:
    """Effective weights in torch's (d_out, d_in) layout, each layer
    zero-padded to (round_up(d_out, 8), round_up(d_in, 16)); the last
    layer is its column 0 as one row. Biases f32, padded alike."""
    cfg = dict(sdf_cfg_items)
    if cfg["d_in"] != 3:
        raise ValueError("the fused SDF MLP takes 3-d points")
    shapes = sdf_layer_shapes(cfg)
    n_layers = len(shapes)
    skip = tuple(cfg["skip_in"])
    if any(s <= 0 or s >= n_layers - 1 for s in skip):
        raise ValueError(f"skip layers {skip} must be hidden layers past the first")
    act = act_dtype_of(act_dtype)
    if act == torch.bfloat16 and cfg["d_hidden"] % 16:
        raise ValueError("the tensor-core SDF MLP needs d_hidden to be a multiple of 16")
    ws, bs, k, kpad, n, npad, woff, boff = [], [], [], [], [], [], [], []
    wo = bo = 0
    for l, (d_in, d_out) in enumerate(shapes):
        layer = net.layer(l)
        w = layer_weight(layer).float()  # (d_out, d_in)
        b = layer.bias.float()
        if l == n_layers - 1:
            w, b, d_out, rows = w[:1], b[:1], 1, 1
        else:
            rows = _round_up(d_out, 8)
        cols = _round_up(d_in, 16)
        w_p = torch.zeros(rows, cols, dtype=torch.float32, device=w.device)
        w_p[:d_out, :d_in] = w
        b_p = torch.zeros(rows, dtype=torch.float32, device=w.device)
        b_p[:d_out] = b
        ws.append(w_p.reshape(-1))
        bs.append(b_p)
        k.append(d_in), kpad.append(cols), n.append(d_out), npad.append(rows)
        woff.append(wo), boff.append(bo)
        wo += rows * cols
        bo += rows
    return PackedSDF(
        w=torch.cat(ws).to(act).contiguous(), b=torch.cat(bs).contiguous(), act=act,
        multires=int(cfg["multires"]), scale=float(cfg["scale"]),
        skip_mask=sum(1 << s for s in skip), k=tuple(k), kpad=tuple(kpad), n=tuple(n),
        npad=tuple(npad), woff=tuple(woff), boff=tuple(boff))


def sdf_mlp_plain(packed: PackedSDF, pts: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K1: (N, 3) -> (N,) f32. Products of
    act-dtype values are summed in f32 (an f32 matmul of bf16-rounded
    operands is exact per product)."""
    act = packed.act
    x = pts.float() * packed.scale
    h = positional_encoding(x, packed.multires).to(act)
    pe_a = h
    n_layers = len(packed.k)
    for l in range(n_layers):
        w, b = packed.layer(l)
        if (packed.skip_mask >> l) & 1:
            h = (torch.cat([h, pe_a], dim=-1).float() * _INV_SQRT2).to(act)
        z = h.float() @ w.float().t() + b
        h = F.softplus(z, beta=100.0, threshold=20.0).to(act) if l < n_layers - 1 else z
    return h[:, 0] / packed.scale


def _int_array(ctype, values):
    arr = (ctype * len(values))(*values)
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def fused_sdf_head(packed: PackedSDF, pts: torch.Tensor) -> torch.Tensor:
    """SDF at (N, 3) float32 points -> (N,) float32. CPU tensors take the
    plain version; CUDA tensors launch K1, or raise."""
    if pts.dim() != 2 or pts.shape[1] != 3 or pts.dtype != torch.float32:
        raise ValueError(f"expected (N, 3) float32 points, got {tuple(pts.shape)} {pts.dtype}")
    if pts.device.type == "cpu":
        return sdf_mlp_plain(packed, pts)
    if pts.device.type != "cuda" or packed.w.device != pts.device:
        raise ValueError(f"points on {pts.device}, weights on {packed.w.device}")
    pts = pts.contiguous()
    out = torch.empty(pts.shape[0], dtype=torch.float32, device=pts.device)
    keep = [_int_array(ctypes.c_int, packed.k), _int_array(ctypes.c_int, packed.kpad),
            _int_array(ctypes.c_int, packed.n), _int_array(ctypes.c_int, packed.npad),
            _int_array(ctypes.c_longlong, packed.woff), _int_array(ctypes.c_int, packed.boff)]
    err = kernels().nw_sdf_mlp(
        pts.data_ptr(), pts.shape[0], packed.w.data_ptr(), packed.b.data_ptr(),
        int(packed.act == torch.bfloat16), len(packed.k), packed.multires, packed.scale,
        packed.skip_mask, *(ptr for _, ptr in keep), out.data_ptr(), stream_handle(pts.device))
    check("nw_sdf_mlp", err)
    fused_sdf_head.launches += 1
    fused_sdf_head.launches_f32 += int(packed.act != torch.bfloat16)
    return out


# launches of K1, and of those the float32 ones
fused_sdf_head.launches = 0
fused_sdf_head.launches_f32 = 0


def fused_field_sdf(model, fc, pts: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``models.neuconw.field_sdf`` on gradient-free paths:
    (..., 3) -> (...), always float32 (``pallas_mlp.py:195-210``)."""
    packed = pack_sdf_weights(model.neuconw.sdf_net, fc.sdf, "float32")
    return fused_sdf_head(packed, pts.reshape(-1, 3).float()).reshape(pts.shape[:-1])
