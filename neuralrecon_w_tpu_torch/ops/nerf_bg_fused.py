"""The fused NeRF++ background, forward and backward: Hopper kernels K8
(forward) and K9 (backward) in ``csrc/nerf_bg.cu``, K5 for the dW
reduction (``csrc/sdf_vjp.cu``), and their plain PyTorch versions.

Port of ``neuralrecon_w_tpu/ops/pallas_nerf_bg.py``: ``bg_fwd_pallas`` (K8:
density (N, 1) and rgb (N, 3) of the 8 x 256 MLP with its skip, the alpha
and feature heads and the appearance head), ``bg_bwd_pallas`` (K9: the
forward recomputed, its first-order reverse, d_pts4, d_dirs and d_a; the
per-layer (cotangent, input) rows K5 reduces into dW / db) and the custom
VJP around them, ``nerf_bg_pallas``, here ``_NerfBG``.

Rounding is the TPU kernel's (``_bg_forward`` ``:150-184``,
``_bg_bwd_kernel`` ``:200-307``): every GEMM operand is cast to the
activation dtype, sums and biases are f32, the hidden state stays f32
between layers. The plain versions are explicit layer loops that round
there; they are not ``models/nerf_bg.apply_nerf_bg``, which rounds
elsewhere and takes the per-ray head shortcut.

``nerf_bg_kernel`` runs the plain versions for tensors on the CPU and
launches the kernels for CUDA tensors; it has no other path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..models.layers import layer_bias, layer_weight
from ..models.nerf_bg import NeRF
from ..models.sdf import act_dtype_of
from . import field_vjp_math as fvm
from .build import check, kernels, stream_handle
from .field_forward import check_rows
from .sdf_field_vjp import WMAX, _net_args, dw_reduce_rows, pack_layers

D, SKIP, MULTIRES, MULTIRES_VIEW, D_IN = 8, 4, 10, 4, 4
ALPHA, FEATURE, HEAD = D, D + 1, D + 2  # layer indices in bg_layer_names order
CHUNK = 32768  # points per K8 / K9 launch
_TILE = 64
D_PE = D_IN * (1 + 2 * MULTIRES)  # 84
PE_PAD = 96  # the PE's columns in the kernels' operand and in their pack of pts5


def bwd_slots(n_head: int) -> int:
    """K9's workspace rows per point: every layer's input (feature shares
    alpha's) and cotangent."""
    return 21 + 2 * n_head


def bg_layer_names(encode_a: bool) -> list:
    """The TPU kernel's layer order (``pallas_nerf_bg.py:66-72``)."""
    head = [f"app{s}" for s in range(D // 2)] if encode_a else ["views0"]
    return [f"pts{i}" for i in range(D)] + ["alpha", "feature"] + head + ["rgb"]


def bg_layers(net: NeRF, encode_a: bool) -> list:
    """The background's linears in ``bg_layer_names`` order."""
    if encode_a:
        head = [net.apperence_encoding.layer(s) for s in range(net.apperence_encoding.n_layers)]
    else:
        head = [net.views_linears[0]]
    return list(net.pts_linears) + [net.alpha_linear, net.feature_linear] + head + [net.rgb_linear]


class BgPack(NamedTuple):
    """The background's weights packed as ``sdf_field_vjp.pack_layers``
    packs them, in ``bg_layer_names`` order. The concatenated inputs keep
    torch's column order, each segment contiguous: app0 takes [feature |
    PE_view | a], views0 [feature | PE_view], pts5 [pe | h] with the PE
    padded by zero columns to PE_PAD, so that h starts on a whole k-step of
    the kernels' products (k stays 84 + W, the width of the rows K5
    reduces; kpad is PE_PAD + W)."""

    w: torch.Tensor
    b: torch.Tensor
    act: torch.dtype
    n_head: int
    k: tuple
    n: tuple
    kpad: tuple
    npad: tuple
    w_off: tuple
    wt_off: tuple
    b_off: tuple


@torch.no_grad()
def pack_bg_weights(weights, biases, act) -> BgPack:
    weights = list(weights)
    k = tuple(w.shape[1] for w in weights)
    w5 = weights[SKIP + 1]
    weights[SKIP + 1] = torch.cat([w5[:, :D_PE], w5.new_zeros(w5.shape[0], PE_PAD - D_PE),
                                   w5[:, D_PE:]], dim=1)
    pk = pack_layers(weights, biases, act)
    return BgPack(n_head=len(weights) - HEAD - 1, **(pk | {"k": k}))


def _pe_T(v, multires, g):
    """Jpe(v)^T g for the PE of a d-vector (``pallas_nerf_bg.py:138-147``)."""
    d = v.shape[-1]
    out = g[:, :d]
    for i in range(multires):
        f = 2.0 ** i
        s_off, c_off = d * (1 + 2 * i), d * (2 + 2 * i)
        out = out + g[:, s_off:s_off + d] * f * torch.cos(f * v)
        out = out - g[:, c_off:c_off + d] * f * torch.sin(f * v)
    return out


def _forward(ws, bs, pts4, dirs, a, act, masks=None) -> dict:
    """The forward, keeping each layer's input: ins[i] of the MLP (ins[5] =
    [pe, h5]) and ins[8] = h8, heads[s] of the appearance head, and zs the
    pre-activations of the ReLU layers (pts0..7, then the head's).
    ``masks`` (one bool tensor per ReLU, as ``zs``) stands in for the
    pre-activations' own signs."""
    pe = fvm._pe(pts4, MULTIRES)

    def lin(i, x):
        return fvm._mm(x, ws[i].t(), act) + bs[i]

    def relu(z):
        zs.append(z)
        return torch.relu(z) if masks is None else z * masks[len(zs) - 1]

    ins, zs = [pe], []
    for i in range(D):
        h = relu(lin(i, ins[-1]))
        ins.append(torch.cat([pe, h], dim=-1) if i == SKIP else h)
    feat = lin(FEATURE, ins[D])
    heads = [torch.cat([feat, fvm._pe(dirs, MULTIRES_VIEW)] + ([] if a is None else [a]), dim=-1)]
    for s in range(len(ws) - HEAD - 1):
        heads.append(relu(lin(HEAD + s, heads[-1])))
    return dict(ins=ins, heads=heads, zs=zs, density=lin(ALPHA, ins[D]),
                rgb=lin(len(ws) - 1, heads[-1]))


def bg_fwd_plain(ws, bs, pts4, dirs, a, act="float32"):
    """The plain version of K8: (density (N, 1), rgb (N, 3)); a is None
    without the appearance code. Weights (d_out, d_in) in
    ``bg_layer_names`` order."""
    res = _forward(ws, bs, pts4, dirs, a, act_dtype_of(act))
    return res["density"], res["rgb"]


def bg_preacts(ws, bs, pts4, dirs, a, act="float32") -> list:
    """The pre-activations of the background's ReLU layers (pts0..7, then
    the head's), (N, n) each; their signs are the masks the backward takes."""
    return _forward(ws, bs, pts4, dirs, a, act_dtype_of(act))["zs"]


def bg_bwd_plain(ws, bs, pts4, dirs, a, c_density, c_rgb, act="float32", masks=None):
    """The plain version of K9 + K5: (dWs, dbs, d_pts4 (N, 4), d_dirs (N, 3),
    d_a (N, n_a) or None) for cotangents on density (N, 1) and rgb (N, 3).
    ``masks``, one bool tensor per ReLU (``nerf_bg_bwd`` reads K9's),
    replaces the ReLUs' own signs in the forward and the backward."""
    act = act_dtype_of(act)
    res = _forward(ws, bs, pts4, dirs, a, act, masks)
    ins, heads = res["ins"], res["heads"]
    masks = [z > 0 for z in res["zs"]] if masks is None else masks
    H = len(heads) - 1
    dWs, dbs = [None] * len(ws), [None] * len(ws)

    def emit(i, inp, g):
        dWs[i], dbs[i] = fvm._mm(g.t(), inp, act), g.sum(dim=0)

    def back(i, g):
        return fvm._mm(g, ws[i], act)

    emit(len(ws) - 1, heads[H], c_rgb)
    g = back(len(ws) - 1, c_rgb)
    for s in range(H - 1, -1, -1):
        g = g * masks[D + s]
        emit(HEAD + s, heads[s], g)
        g = back(HEAD + s, g)
    f = ins[D].shape[1]
    d_feat, d_pev = g[:, :f], g[:, f:f + 3 * (1 + 2 * MULTIRES_VIEW)]
    d_a = None if a is None else g[:, f + d_pev.shape[1]:]
    emit(FEATURE, ins[D], d_feat)
    emit(ALPHA, ins[D], c_density)
    g = back(FEATURE, d_feat) + back(ALPHA, c_density)
    d_pe = torch.zeros_like(ins[0])
    n_pe = ins[0].shape[1]
    for i in range(D - 1, -1, -1):
        g = g * masks[i]
        emit(i, ins[i], g)
        g = back(i, g)
        if i == SKIP + 1:
            d_pe, g = d_pe + g[:, :n_pe], g[:, n_pe:]
        elif i == 0:
            d_pe = d_pe + g
    return dWs, dbs, _pe_T(pts4, MULTIRES, d_pe), _pe_T(dirs, MULTIRES_VIEW, d_pev), d_a


def _check(kernel: str, pk: BgPack, pts4, dirs, a, *more):
    dev = pts4.device
    if pk.w.device != dev:
        raise ValueError(f"{kernel} takes CUDA tensors on one device; points on {dev}, "
                         f"weights on {pk.w.device}")
    named = [("pts4", pts4, D_IN), ("dirs", dirs, 3)] + ([] if a is None else [("a", a, None)])
    check_rows(kernel, dev, pts4.shape[0], *named, *more)


def workspace(n_pts: int, slots: int, dev):
    """K9's float32 workspace of ``slots`` rows per point for one chunk, and
    its rows per slot."""
    rows = (min(n_pts, CHUNK) + _TILE - 1) // _TILE * _TILE
    return torch.empty(slots * rows * WMAX, dtype=torch.float32, device=dev), rows


def nerf_bg_fwd(pk: BgPack, pts4, dirs, a):
    """K8 on CUDA tensors, one launch per CHUNK points: (density (N, 1),
    rgb (N, 3))."""
    _check("K8", pk, pts4, dirs, a)
    dev, n_pts = pts4.device, pts4.shape[0]
    pts4, dirs = pts4.contiguous(), dirs.contiguous()
    a = None if a is None else a.contiguous()
    n_a = 0 if a is None else a.shape[1]
    density = torch.empty(n_pts, 1, dtype=torch.float32, device=dev)
    rgb = torch.empty(n_pts, 3, dtype=torch.float32, device=dev)
    keep, ptrs = _net_args(pk)
    for c0 in range(0, n_pts, CHUNK):
        m = min(CHUNK, n_pts - c0)
        err = kernels().nw_bg_fwd(
            pts4[c0:].data_ptr(), dirs[c0:].data_ptr(), 0 if a is None else a[c0:].data_ptr(), m,
            pk.w.data_ptr(), pk.b.data_ptr(), int(pk.act == torch.bfloat16), len(pk.k),
            pk.n_head, n_a, *ptrs, density[c0:].data_ptr(), rgb[c0:].data_ptr(),
            stream_handle(dev))
        check("nw_bg_fwd", err)
        nerf_bg_fwd.launches += 1
    del keep
    return density, rgb


nerf_bg_fwd.launches = 0


def nerf_bg_bwd(pk: BgPack, pts4, dirs, a, c_density, c_rgb, masks=None):
    """K9 on CUDA tensors, one launch per CHUNK points, each followed by K5
    on every layer's (cotangent, input) rows: the plain version's outputs.
    A list passed as ``masks`` receives the ReLU masks K9 applied
    (``bg_masks``, every point), which the plain version can take."""
    n_pts = pts4.shape[0]
    _check("K9", pk, pts4, dirs, a, ("c_density", c_density, 1), ("c_rgb", c_rgb, 3))
    dev = pts4.device
    pts4, dirs = pts4.contiguous(), dirs.contiguous()
    a = None if a is None else a.contiguous()
    n_a = 0 if a is None else a.shape[1]
    cot = torch.cat([c_density, c_rgb], dim=1).contiguous()
    NL = len(pk.k)
    slots = bwd_slots(pk.n_head)
    work, rows = workspace(n_pts, slots, dev)
    dWs = [torch.zeros(n, k, dtype=torch.float32, device=dev) for n, k in zip(pk.n, pk.k)]
    dbs = [torch.zeros(n, dtype=torch.float32, device=dev) for n in pk.n]
    d_p4 = torch.empty(n_pts, D_IN, dtype=torch.float32, device=dev)
    d_dirs = torch.empty(n_pts, 3, dtype=torch.float32, device=dev)
    d_a = None if a is None else torch.empty(n_pts, n_a, dtype=torch.float32, device=dev)
    keep, ptrs = _net_args(pk)
    chunk_masks = []
    for c0 in range(0, n_pts, CHUNK):
        m = min(CHUNK, n_pts - c0)
        err = kernels().nw_bg_bwd(
            pts4[c0:].data_ptr(), dirs[c0:].data_ptr(), 0 if a is None else a[c0:].data_ptr(),
            cot[c0:].data_ptr(), m, pk.w.data_ptr(), pk.b.data_ptr(),
            int(pk.act == torch.bfloat16), NL, pk.n_head, n_a, *ptrs, work.data_ptr(), rows,
            slots, d_p4[c0:].data_ptr(), d_dirs[c0:].data_ptr(),
            0 if d_a is None else d_a[c0:].data_ptr(), stream_handle(dev))
        check("nw_bg_bwd", err)
        nerf_bg_bwd.launches += 1
        reduce_chunk(pk, work, rows, m, dWs, dbs)
        if masks is not None:
            chunk_masks.append(bg_masks(pk, work, rows, m))
    del keep
    if masks is not None:
        masks.extend(torch.cat(c) for c in zip(*chunk_masks))
    return dWs, dbs, d_p4, d_dirs, d_a


def bg_masks(pk: BgPack, work, rows: int, n_pts: int) -> list:
    """The ReLU masks K9 applied to n_pts points, read off the layers'
    inputs it left in the workspace: one (n_pts, n) bool tensor per ReLU
    layer, pts l's output in slot l + 1 (pts4's past the PE in slot 5),
    head layer s's in slot HEAD + s."""
    view = work.view(-1, rows, WMAX)
    out = [view[l + 1, :n_pts, D_PE if l == SKIP else 0:][:, :pk.n[l]] > 0 for l in range(D)]
    return out + [view[HEAD + s, :n_pts, :pk.n[HEAD + s]] > 0 for s in range(pk.n_head)]


def reduce_chunk(pk: BgPack, work, rows: int, n_pts: int, dWs, dbs) -> None:
    """K5 over the (cotangent, input) rows K9 left for n_pts points: layer
    i's input in slot i (feature reads alpha's), i - 1 past feature; its
    cotangent in slot NL - 1 + i (csrc/nerf_bg.cu)."""
    NL, lw = len(pk.k), rows * WMAX
    for i in range(NL):
        x, y = (NL - 1 + i) * lw, (i if i <= ALPHA else i - 1) * lw
        dw_reduce_rows(work, x, y, pk.n[i], pk.k[i], n_pts, pk.act, dWs[i], dbs[i])


nerf_bg_bwd.launches = 0


class _NerfBG(torch.autograd.Function):
    """(density, rgb) over (pts4, dirs, a, W / b), with the hand-derived
    backward (``pallas_nerf_bg.py:447-469``)."""

    @staticmethod
    def forward(ctx, act, pts4, dirs, a, *wb):
        n = len(wb) // 2
        pk = pack_bg_weights(wb[:n], wb[n:], act)
        ctx.act, ctx.pack = act, pk
        ctx.has_a = a is not None
        ctx.save_for_backward(pts4, dirs, *([] if a is None else [a]), *wb)
        if pts4.device.type == "cpu":
            return bg_fwd_plain(wb[:n], wb[n:], pts4, dirs, a, act)
        return nerf_bg_fwd(pk, pts4, dirs, a)

    @staticmethod
    @once_differentiable
    def backward(ctx, c_density, c_rgb):
        saved = ctx.saved_tensors
        pts4, dirs = saved[:2]
        a, wb = (saved[2], saved[3:]) if ctx.has_a else (None, saved[2:])
        n = len(wb) // 2
        c_density = pts4.new_zeros(pts4.shape[0], 1) if c_density is None else c_density
        c_rgb = pts4.new_zeros(pts4.shape[0], 3) if c_rgb is None else c_rgb
        if pts4.device.type == "cpu":
            out = bg_bwd_plain(wb[:n], wb[n:], pts4, dirs, a, c_density, c_rgb, ctx.act)
        else:
            out = nerf_bg_bwd(ctx.pack, pts4, dirs, a, c_density, c_rgb)
        dWs, dbs, d_p4, d_dirs, d_a = out
        return (None, d_p4, d_dirs, d_a, *dWs, *dbs)


def nerf_bg_kernel(net: NeRF, encode_a: bool, pts4, dirs, a=None, act="float32"):
    """Drop-in for ``models.nerf_bg.apply_nerf_bg`` at per-point dirs and
    a (``pallas_nerf_bg.py:472-484``): (density (N, 1), rgb (N, 3)),
    differentiable in the parameters, pts4, dirs and a. CPU tensors take
    the plain versions; CUDA tensors launch K8 forward and K9 + K5
    backward, or raise."""
    layers = bg_layers(net, encode_a)
    return _NerfBG.apply(act, pts4, dirs, a if encode_a else None,
                         *[layer_weight(m) for m in layers], *[layer_bias(m) for m in layers])
