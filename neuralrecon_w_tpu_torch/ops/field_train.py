"""The fused foreground field in training, forward and backward: Hopper
kernels K6 (forward, ``csrc/field_fwd.cu``), K7 (backward,
``csrc/field_bwd.cu``) with K5 (the dW reduction, ``csrc/sdf_vjp.cu``), and
their plain PyTorch versions.

Port of ``neuralrecon_w_tpu/ops/pallas_field_train.py``: ``field_fwd_pallas``
computes the same (rgb, sdf, grad) as ``pallas_field.fused_field_forward``,
whose port is K6, so the forward launches K6; ``field_bwd_pallas`` (the
colour head's backward, its cotangents injected into the SDF's second-order
VJP) is K7, which leaves per layer the dW factor pairs that K5 reduces. The
custom VJP around them, ``field_rgb_sdf_grad_pallas``, is ``_FieldTrain``
here, over the effective weights: the weight-norm (v, g) -> W chain stays
in autograd, as in ``ops/sdf_field_vjp.py``.

Rounding is the TPU kernel's in the activation dtype: every GEMM operand
is rounded to it, every product summed in float32, biases added in
float32; ``field_train_bwd_plain`` is written as explicit layer loops that
round at those places (``pallas_field_train.py:159-242, 330-345``), then
runs ``ops/field_vjp_math.backward``.

``field_rgb_sdf_grad_kernel`` runs the plain versions for tensors on the
CPU and launches the kernels for CUDA tensors; it has no other path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..models.layers import layer_bias, layer_weight
from ..models.sdf import act_dtype_of
from . import field_vjp_math as fvm
from .build import check, kernels, stream_handle
from .field_forward import (
    FieldPack,
    check_rows,
    color_layers,
    field_forward_kernel,
    field_forward_plain,
    pack_color_tensors,
)
from .sdf_field_vjp import WMAX, _net_args, dw_reduce, dw_reduce_rows, pack_vjp_weights

CHUNK = 32768  # points per K7 launch; bounds the workspace to a few GB
_TILE = 64  # the workspace is allocated in whole tiles


class FieldSpec(NamedTuple):
    """What the kernels need besides the weights: the SDF cfg items, the
    colour head's static layers and view PE, the activation dtype."""

    sdf: tuple
    n_sdf: int
    n_static: int
    multires_view: int
    act: str

    @property
    def skip(self) -> tuple:
        return tuple(dict(self.sdf)["skip_in"])

    @property
    def multires(self) -> int:
        return int(dict(self.sdf)["multires"])

    @property
    def scale(self) -> float:
        return float(dict(self.sdf)["scale"])


def _split(spec: FieldSpec, wb):
    """(SDF weights, SDF biases, colour weights, colour biases)."""
    L, C = spec.n_sdf, (len(wb) - 2 * spec.n_sdf) // 2
    return wb[:L], wb[L:2 * L], wb[2 * L:2 * L + C], wb[2 * L + C:]


def pack_field_tensors(spec: FieldSpec, wb) -> FieldPack:
    ws, bs, cws, cbs = _split(spec, wb)
    return FieldPack(pack_vjp_weights(ws, bs, dict(spec.sdf), spec.act),
                     pack_color_tensors(cws, cbs, spec.n_static, spec.multires_view, spec.act))


def _color_forward(spec: FieldSpec, cws, cbs, res, pts, dirs, a, act, masks=None):
    """The colour head's forward on the SDF forward's residuals: (xs, zs, z,
    xf, pev), xs[i - 1] colour layer i's input for i >= 1, zs the
    pre-activations of the layers with a ReLU (1 .. C - 2), z the last
    layer's. ``masks`` (one bool tensor per ReLU, as ``zs``) stands in for
    the pre-activations' own signs."""
    S, C = spec.n_static, len(cws)

    def lin(i, x):
        return fvm._mm(x, cws[i].t(), act) + cbs[i]

    xf = lin(0, res["out"][:, 1:])
    pev = fvm._pe(dirs, spec.multires_view)
    xs, zs = [torch.cat([xf, pev, a], dim=-1)], []
    for i in range(1, C - 1):
        zs.append(lin(i, xs[-1]))
        h = zs[-1] * (zs[-1] > 0 if masks is None else masks[i - 1])
        xs.append(torch.cat([pts, res["grad"], h], dim=-1) if i == S else h)
    return xs, zs, lin(C - 1, xs[-1]), xf, pev


def color_preacts(spec: FieldSpec, wb, pts, dirs, a) -> list:
    """The pre-activations of the colour layers with a ReLU, (N, n) each, in
    the inputs' float dtype; their signs are the masks the backward takes."""
    ws, bs, cws, cbs = _split(spec, wb)
    act = act_dtype_of(spec.act)
    res = fvm.forward_with_residuals(ws, bs, spec.skip, spec.multires, spec.scale, pts, act)
    return _color_forward(spec, cws, cbs, res, pts, dirs, a, act)[1]


def field_train_bwd_plain(spec: FieldSpec, wb, pts, dirs, a, c_rgb, c_sdf, c_grad, masks=None):
    """The plain version of K7 + K5: (SDF dWs, dbs, colour dWs, dbs, dx
    (N, 3), d_dirs (N, 3), d_a (N, n_a)) for cotangents on rgb (N, 3), sdf
    (N,) and grad (N, 3); weights (d_out, d_in) in ``wb`` as ``_split``
    orders them. Runs in the inputs' float dtype (float64 for a reference),
    rounding GEMM operands to ``spec.act``. ``masks``, one bool tensor per
    colour ReLU (``field_train_bwd`` reads K7's), replaces the ReLUs' own
    signs in the forward and the backward."""
    ws, bs, cws, cbs = _split(spec, wb)
    act = act_dtype_of(spec.act)
    S, C = spec.n_static, len(cws)
    res = fvm.forward_with_residuals(ws, bs, spec.skip, spec.multires, spec.scale, pts, act)
    xs, zs, z, xf, pev = _color_forward(spec, cws, cbs, res, pts, dirs, a, act, masks)
    masks = [z_ > 0 for z_ in zs] if masks is None else masks
    sig = torch.sigmoid(z)

    # the colour backward: layer i's input cotangent g W, masked by layer
    # i - 1's ReLU; lin0's splits into d_pts, d_grad and the static head's
    dW, db = [None] * C, [None] * C
    g = c_rgb * sig * (1.0 - sig)
    for i in range(C - 1, 0, -1):
        dW[i], db[i] = fvm._mm(g.t(), xs[i - 1], act), g.sum(dim=0)
        g = fvm._mm(g, cws[i], act)
        if i == 1 + S:
            d_pts, d_grad, g = g[:, :3], g[:, 3:6], g[:, 6:]
        if i > 1:
            g = g * masks[i - 2]
    n0, dv = xf.shape[1], pev.shape[1]
    d_xf, d_a = g[:, :n0], g[:, n0 + dv:]
    dW[0], db[0] = fvm._mm(d_xf.t(), res["out"][:, 1:], act), d_xf.sum(dim=0)
    d_dirs = fvm._pe_jac_T(dirs, spec.multires_view, g[:, n0:n0 + dv])

    # the injection: the SDF output's cotangent [c_sdf / scale | d_feature]
    c_out = torch.cat([c_sdf[:, None] / spec.scale, fvm._mm(d_xf, cws[0], act)], dim=-1)
    dWs, dbs, dx = fvm.backward(ws, bs, spec.skip, spec.multires, spec.scale, res, c_out,
                                c_grad + d_grad, act)
    return dWs, dbs, dW, db, dx + d_pts, d_dirs, d_a


def color_slots(n_color: int) -> int:
    """K7's workspace slots past the SDF's 6 per layer (csrc/field_bwd.cu)."""
    return 2 * n_color + 1


def workspace(n_pts: int, pack: FieldPack, device):
    """K7's float32 workspace for one chunk, and its rows per slot."""
    rows = (min(n_pts, CHUNK) + _TILE - 1) // _TILE * _TILE
    slots = 6 * len(pack.sdf.k) + color_slots(len(pack.color.k))
    return torch.empty(slots * rows * WMAX, dtype=torch.float32, device=device), rows


def reduce_chunk(pack: FieldPack, work, rows: int, n_pts: int, dWs, dbs, cdWs, cdbs) -> None:
    """K5 over the factor pairs K7 left for n_pts points: adds every SDF
    layer's and colour layer's dW and db."""
    sp, cp = pack.sdf, pack.color
    L, C = len(sp.k), len(cp.k)
    lw, base, n0 = rows * WMAX, 6 * L, cp.n[0]
    for l in range(L):
        dw_reduce(sp, work, rows, l, n_pts, dWs[l], dbs[l])
    # colour layer i: its cotangent in slot base + C + 1 + i, its input in
    # slot base + 1 + i; xyz_final's input is the SDF output row's feature
    # columns, the static head's first is [xyz_final | view]
    for i in range(C):
        x = (base + C + 1 + i) * lw
        if i == 0:
            dw_reduce_rows(work, x, base * lw + 1, cp.n[0], cp.k[0], n_pts, sp.act, cdWs[0],
                           cdbs[0])
        elif i == 1:
            dw_reduce_rows(work, x, (base + 2) * lw, cp.n[1], n0, n_pts, sp.act, cdWs[1][:, :n0],
                           cdbs[1])
            dw_reduce_rows(work, x, (base + 1) * lw, cp.n[1], cp.k[1] - n0, n_pts, sp.act,
                           cdWs[1][:, n0:])
        else:
            dw_reduce_rows(work, x, (base + 1 + i) * lw, cp.n[i], cp.k[i], n_pts, sp.act,
                           cdWs[i], cdbs[i])


def color_masks(pack: FieldPack, work, rows: int, n_pts: int) -> list:
    """The ReLU masks K7 applied to n_pts points, read off the colour
    layers' inputs it left in the workspace: one (n_pts, n) bool tensor per
    colour layer with a ReLU (1 .. C - 2), layer i's output in slot
    6 L + 2 + i (the last static layer's past [x, grad])."""
    cp, base = pack.color, 6 * len(pack.sdf.k)
    view = work.view(-1, rows, WMAX)
    return [view[base + 2 + i, :n_pts, 6 if i == cp.n_static else 0:][:, :cp.n[i]] > 0
            for i in range(1, len(cp.k) - 1)]


def field_train_bwd(pack: FieldPack, pts, dirs, a, c_rgb, c_sdf, c_grad, masks=None):
    """K7 on CUDA tensors, one launch per CHUNK points, each followed by K5
    on every layer's factor pairs: the plain version's outputs. A list
    passed as ``masks`` receives the colour ReLU masks K7 applied
    (``color_masks``, every point), which the plain version can take."""
    sp, cp = pack.sdf, pack.color
    dev = pts.device
    if sp.w.device != dev or cp.w.device != dev:
        raise ValueError(f"K7 takes CUDA tensors on one device; points on {dev}, "
                         f"weights on {sp.w.device} / {cp.w.device}")
    n_pts, n_a = pts.shape[0], a.shape[1]
    check_rows("K7", dev, n_pts, ("pts", pts, 3), ("dirs", dirs, 3), ("a", a, None),
               ("c_rgb", c_rgb, 3), ("c_sdf", c_sdf[:, None], 1), ("c_grad", c_grad, 3))
    cot = torch.cat([c_rgb, c_sdf[:, None], c_grad], dim=1).contiguous()
    pts, dirs, a = pts.contiguous(), dirs.contiguous(), a.contiguous()
    L, C = len(sp.k), len(cp.k)
    work, rows = workspace(n_pts, pack, dev)
    zeros = lambda *shape: torch.zeros(*shape, dtype=torch.float32, device=dev)  # noqa: E731
    dWs, dbs = [zeros(n, k) for n, k in zip(sp.n, sp.k)], [zeros(n) for n in sp.n]
    cdWs, cdbs = [zeros(n, k) for n, k in zip(cp.n, cp.k)], [zeros(n) for n in cp.n]
    dx, d_dirs, d_a = zeros(n_pts, 3), zeros(n_pts, 3), zeros(n_pts, n_a)
    keep, sdf_ptrs = _net_args(sp)
    ckeep, cptrs = _net_args(cp)  # the colour pack has the SDF pack's layer tables
    chunk_masks = []
    for c0 in range(0, n_pts, CHUNK):
        m = min(CHUNK, n_pts - c0)
        err = kernels().nw_field_bwd(
            pts[c0:].data_ptr(), dirs[c0:].data_ptr(), a[c0:].data_ptr(), cot[c0:].data_ptr(), m,
            sp.w.data_ptr(), sp.b.data_ptr(), int(sp.act == torch.bfloat16), L, sp.multires,
            sp.scale, sp.skip_mask, *sdf_ptrs, cp.w.data_ptr(), cp.b.data_ptr(), C, cp.n_static,
            cp.multires_view, n_a, *cptrs, work.data_ptr(), rows, work.numel() // (rows * WMAX),
            dx[c0:].data_ptr(), d_dirs[c0:].data_ptr(), d_a[c0:].data_ptr(), stream_handle(dev))
        check("nw_field_bwd", err)
        field_train_bwd.launches += 1
        reduce_chunk(pack, work, rows, m, dWs, dbs, cdWs, cdbs)
        if masks is not None:
            chunk_masks.append(color_masks(pack, work, rows, m))
    del keep, ckeep
    if masks is not None:
        masks.extend(torch.cat(c) for c in zip(*chunk_masks))
    return dWs, dbs, cdWs, cdbs, dx, d_dirs, d_a


field_train_bwd.launches = 0


class _FieldTrain(torch.autograd.Function):
    """(rgb, sdf, grad) over (pts, dirs, a, SDF W / b, colour W / b), with
    the hand-derived backward (``pallas_field_train.py:526-547``)."""

    @staticmethod
    def forward(ctx, spec, pts, dirs, a, *wb):
        pack = pack_field_tensors(spec, wb)
        ctx.spec, ctx.pack = spec, pack
        ctx.save_for_backward(pts, dirs, a, *wb)
        if pts.device.type == "cpu":
            return field_forward_plain(pack, pts, dirs, a)
        return field_forward_kernel(pack, pts, dirs, a)

    @staticmethod
    @once_differentiable
    def backward(ctx, c_rgb, c_sdf, c_grad):
        pts, dirs, a, *wb = ctx.saved_tensors
        c_rgb = torch.zeros_like(pts) if c_rgb is None else c_rgb
        c_sdf = pts.new_zeros(pts.shape[0]) if c_sdf is None else c_sdf
        c_grad = torch.zeros_like(pts) if c_grad is None else c_grad
        if pts.device.type == "cpu":
            out = field_train_bwd_plain(ctx.spec, wb, pts, dirs, a, c_rgb, c_sdf, c_grad)
        else:
            out = field_train_bwd(ctx.pack, pts, dirs, a, c_rgb, c_sdf, c_grad)
        dWs, dbs, cdWs, cdbs, dx, d_dirs, d_a = out
        return (None, dx, d_dirs, d_a, *dWs, *dbs, *cdWs, *cdbs)


def field_spec(model, fc) -> FieldSpec:
    cnet = model.neuconw.color_net
    return FieldSpec(sdf=fc.sdf, n_sdf=model.neuconw.sdf_net.n_layers,
                     n_static=cnet.static_encoding.n_layers,
                     multires_view=int(dict(fc.color)["multires_view"]), act=fc.act_dtype)


def field_weights(model) -> list:
    """The field's effective weights and biases in ``_split``'s order, in
    autograd (the weight norm included)."""
    net = model.neuconw.sdf_net
    sdf = [net.layer(l) for l in range(net.n_layers)]
    col = color_layers(model.neuconw.color_net)
    return ([layer_weight(m) for m in sdf] + [layer_bias(m) for m in sdf]
            + [layer_weight(m) for m in col] + [layer_bias(m) for m in col])


def field_rgb_sdf_grad_kernel(model, fc, pts, dirs, a):
    """(rgb (N, 3), sdf (N,), grad (N, 3)) of the field at per-sample
    points, view directions and appearance codes, differentiable in every
    SDF and colour parameter, in pts, dirs and a
    (``pallas_field_train.py:550-577``). CPU tensors take the plain
    versions; CUDA tensors launch K6 forward and K7 + K5 backward, or
    raise."""
    return _FieldTrain.apply(field_spec(model, fc), pts, dirs, a, *field_weights(model))
