"""Fused field forward: Hopper kernel K6 (``csrc/field_fwd.cu``) and its
plain PyTorch version.

Port of ``neuralrecon_w_tpu/ops/pallas_field.py`` (``fused_field_forward``,
``pack_color_weights``): per point the SDF forward, the reverse sweep for
d sdf / d x and the IDR colour head with the appearance code, giving rgb
(N, 3), sdf (N,) and grad (N, 3), all float32, with no parameter
gradient. Mesh vertex colouring runs it (``parallel/sweep.py``).

Rounding is the TPU kernel's, in the activation dtype ``fc.act_dtype``:
every GEMM operand is rounded to it, every product summed in float32,
biases added in float32, h = sp(z) rounded before it feeds the next
layer, the reverse sweep's cotangent rounded before each transposed
product. ``field_forward_plain`` is written as explicit layer loops that
round at the same places; it is not ``models/color.apply_color``, whose
bf16 path rounds matmul outputs and adds biases in bf16.

``fused_field_forward`` runs the plain version for tensors on the CPU and
launches K6 for CUDA tensors (one launch per CHUNK points); it has no
other path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..models.color import RenderingNetwork
from ..models.layers import layer_bias, layer_weight
from ..models.sdf import act_dtype_of
from . import field_vjp_math as fvm
from .build import check, kernels, stream_handle
from .sdf_field_vjp import VJPPack, _net_args, pack_layers, pack_vjp_weights

WMAX = 528  # the workspace's row stride (csrc/sdf_tile.cuh)
CHUNK = 65536  # points per K6 launch: the colour sweep's chunk
_TILE = 64  # the workspace is allocated in whole tiles


class ColorPack(NamedTuple):
    """The colour net's effective weights, layer by layer xyz_final,
    static0.., lin0.., packed as ``sdf_field_vjp.pack_layers`` packs: W
    zero-padded to (npad, kpad) = (round_up(n, 16), round_up(k, 16)) at
    w_off and W^T at wt_off (K7's transposed products), in the activation
    dtype; biases f32."""

    w: torch.Tensor
    b: torch.Tensor
    act: torch.dtype
    n_static: int
    multires_view: int
    k: tuple
    n: tuple
    kpad: tuple
    npad: tuple
    w_off: tuple
    wt_off: tuple
    b_off: tuple

    def layer(self, i: int):
        """(W (n, k) in the activation dtype, b (n,) f32) of layer i."""
        k, kpad, n, npad = self.k[i], self.kpad[i], self.n[i], self.npad[i]
        w = self.w[self.w_off[i]:self.w_off[i] + npad * kpad].view(npad, kpad)[:n, :k]
        return w, self.b[self.b_off[i]:self.b_off[i] + n]


class FieldPack(NamedTuple):
    sdf: VJPPack
    color: ColorPack


def color_layers(net: RenderingNetwork) -> list:
    """The colour net's linears in packing order: xyz_final, static0..,
    lin0.."""
    if not hasattr(net, "xyz_encoding_final"):
        raise ValueError("the fused field kernels take the colour net with the appearance head")
    return ([net.xyz_encoding_final]
            + [net.static_encoding.layer(s) for s in range(net.static_encoding.n_layers)]
            + [net.layer(l) for l in range(net.n_layers)])


def pack_color_tensors(weights, biases, n_static: int, multires_view: int, act) -> ColorPack:
    """Effective colour weights (W (d_out, d_in), b) in packing order."""
    return ColorPack(n_static=n_static, multires_view=multires_view,
                     **pack_layers([w.float() for w in weights], biases, act))


@torch.no_grad()
def pack_color_weights(net: RenderingNetwork, color_cfg_items: tuple, act) -> ColorPack:
    """The colour net with the appearance head packed for K6
    (``pallas_field.py:38-74``): the weight norm of the main branch taken
    in float32, then each layer padded to multiples of 16 (the TPU pads to
    128 lanes); the padding stays zero."""
    layers = color_layers(net)
    return pack_color_tensors([layer_weight(m) for m in layers], [layer_bias(m) for m in layers],
                              net.static_encoding.n_layers,
                              int(dict(color_cfg_items)["multires_view"]), act)


def pack_field(model, fc) -> FieldPack:
    """Both nets of ``model`` packed in ``fc.act_dtype``."""
    net = model.neuconw.sdf_net
    with torch.no_grad():
        ws = [layer_weight(net.layer(l)) for l in range(net.n_layers)]
        bs = [layer_bias(net.layer(l)) for l in range(net.n_layers)]
        sdf = pack_vjp_weights(ws, bs, fc.sdf_cfg, fc.act_dtype)
    return FieldPack(sdf, pack_color_weights(model.neuconw.color_net, fc.color, fc.act_dtype))


def _sdf_layer(pk: VJPPack, l: int):
    k, n, kpad, npad = pk.k[l], pk.n[l], pk.kpad[l], pk.npad[l]
    return pk.w[pk.w_off[l]:pk.w_off[l] + npad * kpad].view(npad, kpad)[:n, :k]


def field_forward_plain(pack: FieldPack, pts, dirs, a):
    """The plain version of K6 on the packed weights: (rgb (N, 3), sdf (N,),
    grad (N, 3)), float32."""
    sp, cp = pack.sdf, pack.color
    act = sp.act
    skip = tuple(l for l in range(len(sp.k)) if (sp.skip_mask >> l) & 1)
    ws = [_sdf_layer(sp, l).float() for l in range(len(sp.k))]
    bs = [sp.b[o:o + n] for o, n in zip(sp.b_off, sp.n)]
    out, grad = fvm.value_and_grad(ws, bs, skip, sp.multires, sp.scale, pts.float(), act)

    def lin(i, x):
        w, b = cp.layer(i)
        return fvm._mm(x, w.float().t(), act) + b

    x = lin(0, out[:, 1:])  # xyz_final on the feature
    view = fvm._pe(dirs.float(), cp.multires_view)
    h = torch.cat([x, view, a.float()], dim=-1)
    for s in range(cp.n_static):
        h = torch.relu(lin(1 + s, h))
    x = torch.cat([pts.float(), grad, h], dim=-1)
    for i in range(1 + cp.n_static, len(cp.k)):
        x = lin(i, x)
        if i < len(cp.k) - 1:
            x = torch.relu(x)
    return torch.sigmoid(x), out[:, 0] / sp.scale, grad


def check_rows(kernel: str, dev, n_pts: int, *named) -> None:
    """Raises unless each (name, tensor, width) is an (n_pts, width) float32
    tensor on the CUDA device dev (width None: any)."""
    if dev.type != "cuda":
        raise ValueError(f"{kernel} takes CUDA tensors; got tensors on {dev}")
    for name, t, width in named:
        if t.dim() != 2 or t.shape[0] != n_pts or t.dtype != torch.float32 or t.device != dev \
                or (width is not None and t.shape[1] != width):
            raise ValueError(f"{kernel}: {name} expected ({n_pts}, {width or 'n'}) float32 on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def field_forward_kernel(pack: FieldPack, pts, dirs, a):
    """K6 on CUDA tensors, one launch per CHUNK points: (rgb, sdf, grad)."""
    sp, cp = pack.sdf, pack.color
    dev = pts.device
    if sp.w.device != dev or cp.w.device != dev:
        raise ValueError(f"K6 takes CUDA tensors on one device; points on {dev}, "
                         f"weights on {sp.w.device} / {cp.w.device}")
    n_pts = pts.shape[0]
    check_rows("K6", dev, n_pts, ("pts", pts, 3), ("dirs", dirs, 3), ("a", a, None))
    pts, dirs, a = pts.contiguous(), dirs.contiguous(), a.contiguous()
    rgb = torch.empty(n_pts, 3, dtype=torch.float32, device=dev)
    sdf = torch.empty(n_pts, dtype=torch.float32, device=dev)
    grad = torch.empty(n_pts, 3, dtype=torch.float32, device=dev)
    slots = len(sp.k) - 1  # z per hidden layer (csrc/field_fwd.cu)
    rows = (min(n_pts, CHUNK) + _TILE - 1) // _TILE * _TILE
    work = torch.empty(slots * rows * WMAX, dtype=torch.float32, device=dev)
    keep, sdf_ptrs = _net_args(sp)
    ckeep = [(ctypes.c_int * len(v))(*v) for v in (cp.k, cp.n, cp.kpad)]
    ckeep += [(ctypes.c_longlong * len(cp.w_off))(*cp.w_off),
              (ctypes.c_int * len(cp.b_off))(*cp.b_off)]
    cptrs = [ctypes.cast(x, ctypes.c_void_p) for x in ckeep]
    n_a = a.shape[1]
    for c0 in range(0, n_pts, CHUNK):
        m = min(CHUNK, n_pts - c0)
        err = kernels().nw_field_fwd(
            pts[c0:].data_ptr(), dirs[c0:].data_ptr(), a[c0:].data_ptr(), m, sp.w.data_ptr(),
            sp.b.data_ptr(), int(sp.act == torch.bfloat16), len(sp.k), sp.multires, sp.scale,
            sp.skip_mask, *sdf_ptrs, cp.w.data_ptr(), cp.b.data_ptr(), len(cp.k), cp.n_static,
            cp.multires_view, n_a, *cptrs, work.data_ptr(), rows, slots, rgb[c0:].data_ptr(),
            sdf[c0:].data_ptr(), grad[c0:].data_ptr(), stream_handle(dev))
        check("nw_field_fwd", err)
        fused_field_forward.launches += 1
    del keep, ckeep
    return rgb, sdf, grad


def fused_field_forward(model, fc, pts, dirs, a, pack: FieldPack | None = None):
    """(rgb (N, 3), sdf (N,), grad (N, 3)) of the field at (N, 3) points,
    view directions (N, 3) and appearance codes (N, n_a), in
    ``fc.act_dtype`` (``pallas_field.py:225-286``). CPU tensors take the
    plain version; CUDA tensors launch K6, or raise. ``pack`` is
    ``pack_field(model, fc)``, made here when not given."""
    pack = pack if pack is not None else pack_field(model, fc)
    if pts.device.type == "cpu":
        return field_forward_plain(pack, pts, dirs, a)
    return field_forward_kernel(pack, pts, dirs, a)


fused_field_forward.launches = 0
