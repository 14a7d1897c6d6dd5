"""The SDF with its input gradient and their hand-derived backward: Hopper
kernels K3, K4, K5 (``csrc/sdf_vjp.cu``) and their plain PyTorch version
(``ops/field_vjp_math.py``).

Port of ``neuralrecon_w_tpu/ops/pallas_field_vjp.py``: ``sdf_fwd_pallas``
(K3: out = [sdf * scale | feature], grad = d sdf / d x), ``sdf_bwd_pallas``
(K4: recompute, the adjoint of the input-gradient sweep and the backward of
the forward, giving dx and per layer the dW factors; K5: the reduction of
those factors into dW and db) and the custom VJP around them,
``sdf_value_feat_grad_pallas``, here a ``torch.autograd.Function`` over the
effective weights. The weight-norm (v, g) -> W chain stays in autograd.

Each wrapper runs the plain version for tensors on the CPU and launches its
kernel for CUDA tensors; it has no other path. ``fwd_impl="plain"`` keeps
the forward plain on any device and the backward in the kernels (the JAX
package's ``pallas_hybrid`` grad mode).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..models.layers import layer_bias, layer_weight
from ..models.sdf import SDFNetwork, act_dtype_of
from . import field_vjp_math as fvm
from .build import check, kernels, stream_handle

WMAX = 528  # the workspace's row stride (csrc/sdf_vjp.cu)
CHUNK = 32768  # points per K3 / K4 launch; bounds the workspace to a few GB
_TILE = 64  # the workspace is allocated in whole tiles


class VJPPack(NamedTuple):
    """Effective weights packed for K3 / K4: per layer W (npad, kpad) and
    W^T (kpad, npad), zero-padded to multiples of 16, in the activation
    dtype; biases float32."""

    w: torch.Tensor
    b: torch.Tensor
    act: torch.dtype
    multires: int
    scale: float
    skip_mask: int
    k: tuple
    n: tuple
    kpad: tuple
    npad: tuple
    w_off: tuple
    wt_off: tuple
    b_off: tuple


def _r16(x: int) -> int:
    return (x + 15) // 16 * 16


@torch.no_grad()
def pack_layers(weights, biases, act) -> dict:
    """Linear layers (W (d_out, d_in), b) packed for the tile GEMMs: per
    layer W as (npad, kpad) at w_off, then W^T as (kpad, npad) at wt_off,
    zero-padded to multiples of 16, flat in the activation dtype; biases
    float32 at b_off. Returns the VJPPack fields of that layout."""
    ws, bs, k, n, kpad, npad, w_off, wt_off, b_off = [], [], [], [], [], [], [], [], []
    wo = bo = 0
    for w, b in zip(weights, biases):
        d_out, d_in = w.shape
        np_, kp = _r16(d_out), _r16(d_in)
        w_p = torch.zeros(np_, kp, dtype=torch.float32, device=w.device)
        w_p[:d_out, :d_in] = w
        ws += [w_p.reshape(-1), w_p.t().contiguous().reshape(-1)]
        bs.append(b.float())
        k.append(d_in), n.append(d_out), kpad.append(kp), npad.append(np_)
        w_off.append(wo), wt_off.append(wo + np_ * kp), b_off.append(bo)
        wo += 2 * np_ * kp
        bo += d_out
    return dict(w=torch.cat(ws).to(act_dtype_of(act)).contiguous(), b=torch.cat(bs).contiguous(),
                act=act_dtype_of(act), k=tuple(k), n=tuple(n), kpad=tuple(kpad),
                npad=tuple(npad), w_off=tuple(w_off), wt_off=tuple(wt_off), b_off=tuple(b_off))


def pack_vjp_weights(weights, biases, cfg: dict, act) -> VJPPack:
    return VJPPack(multires=int(cfg["multires"]), scale=float(cfg["scale"]),
                   skip_mask=sum(1 << s for s in cfg["skip_in"]),
                   **pack_layers(weights, biases, act))


def _net_args(pk: VJPPack):
    """The per-layer host arrays, as ctypes pointers (and the arrays, kept)."""
    arrays = [(ctypes.c_int * len(v))(*v) for v in (pk.k, pk.n, pk.kpad, pk.npad)]
    arrays += [(ctypes.c_longlong * len(v))(*v) for v in (pk.w_off, pk.wt_off)]
    arrays.append((ctypes.c_int * len(pk.b_off))(*pk.b_off))
    return arrays, [ctypes.cast(a, ctypes.c_void_p) for a in arrays]


def _check_cuda(x: torch.Tensor, *tensors) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"tensors on {x.device}: the kernels take CUDA tensors")
    for t in (x,) + tensors:
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError("the SDF-VJP kernels take float32 tensors on one device")


def workspace(n_pts: int, kinds: int, n_layers: int, device):
    """A float32 workspace of kinds x n_layers rows of WMAX floats per point
    for one chunk: K4's holds 6 kinds per layer, K3's z per hidden layer (1
    kind x n_layers - 1)."""
    rows = (min(n_pts, CHUNK) + _TILE - 1) // _TILE * _TILE
    return torch.empty(kinds * n_layers * rows * WMAX, dtype=torch.float32, device=device), rows


def _cfg_args(pk: VJPPack):
    return (int(pk.act == torch.bfloat16), len(pk.k), pk.multires, pk.scale, pk.skip_mask)


def sdf_vjp_fwd(weights, biases, cfg: dict, x: torch.Tensor, act="float32"):
    """(out (N, d_out), grad (N, 3)) of the SDF at x (N, 3). CPU tensors
    take the plain version; CUDA tensors launch K3 (one launch per chunk of
    CHUNK points), or raise."""
    act = act_dtype_of(act)
    skip = tuple(cfg["skip_in"])
    if x.device.type == "cpu":
        return fvm.value_and_grad(weights, biases, skip, int(cfg["multires"]),
                                  float(cfg["scale"]), x, act)
    _check_cuda(x, *weights, *biases)
    pk = pack_vjp_weights(weights, biases, cfg, act)
    x = x.contiguous()
    n_pts = x.shape[0]
    out = torch.empty(n_pts, pk.n[-1], dtype=torch.float32, device=x.device)
    grad = torch.empty(n_pts, 3, dtype=torch.float32, device=x.device)
    work, rows = workspace(n_pts, 1, len(pk.k) - 1, x.device)
    keep, ptrs = _net_args(pk)
    for c0 in range(0, n_pts, CHUNK):
        m = min(CHUNK, n_pts - c0)
        err = kernels().nw_sdf_vjp_fwd(
            x[c0:].data_ptr(), m, pk.w.data_ptr(), pk.b.data_ptr(), *_cfg_args(pk), *ptrs,
            work.data_ptr(), rows, out[c0:].data_ptr(), grad[c0:].data_ptr(),
            stream_handle(x.device))
        check("nw_sdf_vjp_fwd", err)
        sdf_vjp_fwd.launches += 1
    del keep
    return out, grad


sdf_vjp_fwd.launches = 0


def dw_reduce(pk: VJPPack, work, rows: int, layer: int, n_pts: int, dW, db) -> None:
    """K5: adds layer ``layer``'s dW (n, k) and db (n) over the first n_pts
    rows of K4's workspace (or of K7's, whose SDF part is laid out alike)."""
    err = kernels().nw_sdf_vjp_reduce(
        work.data_ptr(), rows, len(pk.k), layer, pk.n[layer], pk.k[layer], n_pts,
        int(pk.act == torch.bfloat16), dW.data_ptr(), db.data_ptr(), stream_handle(dW.device))
    check("nw_sdf_vjp_reduce", err)
    dw_reduce.launches += 1


dw_reduce.launches = 0


def dw_reduce_rows(work, x_off: int, y_off: int, n: int, k: int, n_pts: int, act, dW,
                   db=None) -> None:
    """K5 on one factor pair: adds sum_p x_p^T y_p into dW (n, k columns of a
    float32 matrix whose rows may be wider, as a column slice of a larger
    dW is) and sum_p x_p into db (skipped when None), over n_pts workspace
    rows of WMAX floats, x_p starting at element x_off of ``work`` and y_p
    at y_off. The rows are rounded to the activation dtype as in K5."""
    if dW.dtype != torch.float32 or dW.stride(1) != 1 or dW.shape != (n, k) or (
            db is not None and (db.shape != (n,) or not db.is_contiguous())):
        raise ValueError(f"dw_reduce_rows: dW {tuple(dW.shape)} / db for ({n}, {k})")
    err = kernels().nw_dw_reduce(
        work.data_ptr() + 4 * x_off, work.data_ptr() + 4 * y_off, n, k, n_pts,
        int(act_dtype_of(act) == torch.bfloat16), dW.data_ptr(), dW.stride(0),
        0 if db is None else db.data_ptr(), stream_handle(dW.device))
    check("nw_dw_reduce", err)
    dw_reduce.launches += 1


def sdf_vjp_bwd(weights, biases, cfg: dict, x, c_out, c_grad, act="float32"):
    """(dWs (d_out, d_in), dbs, dx) for cotangents c_out (N, d_out) and
    c_grad (N, 3). CPU tensors take the plain version; CUDA tensors launch
    K4 per chunk of CHUNK points and K5 per layer and chunk, or raise."""
    act = act_dtype_of(act)
    skip = tuple(cfg["skip_in"])
    if x.device.type == "cpu":
        return fvm.vjp(weights, biases, skip, int(cfg["multires"]), float(cfg["scale"]), x,
                       c_out, c_grad, act)
    _check_cuda(x, c_out, c_grad, *weights, *biases)
    pk = pack_vjp_weights(weights, biases, cfg, act)
    x, c_out, c_grad = x.contiguous(), c_out.contiguous(), c_grad.contiguous()
    n_pts, n_layers = x.shape[0], len(pk.k)
    dx = torch.empty(n_pts, 3, dtype=torch.float32, device=x.device)
    dWs = [torch.zeros(n, k, dtype=torch.float32, device=x.device) for n, k in zip(pk.n, pk.k)]
    dbs = [torch.zeros(n, dtype=torch.float32, device=x.device) for n in pk.n]
    work, rows = workspace(n_pts, 6, n_layers, x.device)
    keep, ptrs = _net_args(pk)
    for c0 in range(0, n_pts, CHUNK):
        m = min(CHUNK, n_pts - c0)
        err = kernels().nw_sdf_vjp_bwd(
            x[c0:].data_ptr(), m, c_out[c0:].data_ptr(), c_grad[c0:].data_ptr(),
            pk.w.data_ptr(), pk.b.data_ptr(), *_cfg_args(pk), *ptrs, work.data_ptr(), rows,
            dx[c0:].data_ptr(), stream_handle(x.device))
        check("nw_sdf_vjp_bwd", err)
        sdf_vjp_bwd.launches += 1
        for layer in range(n_layers):
            dw_reduce(pk, work, rows, layer, m, dWs[layer], dbs[layer])
    del keep
    return dWs, dbs, dx


sdf_vjp_bwd.launches = 0


class _SDFValueGrad(torch.autograd.Function):
    """(out, grad) over (x, effective weights, biases), with the
    hand-derived backward (``pallas_field_vjp.py:570-592``)."""

    @staticmethod
    def forward(ctx, spec, x, *wb):
        cfg_items, act, fwd_impl = spec
        n_layers = len(wb) // 2
        weights, biases = wb[:n_layers], wb[n_layers:]
        cfg = dict(cfg_items)
        ctx.spec = spec
        ctx.save_for_backward(x, *wb)
        if fwd_impl == "plain":
            return fvm.value_and_grad(weights, biases, tuple(cfg["skip_in"]),
                                      int(cfg["multires"]), float(cfg["scale"]), x,
                                      act_dtype_of(act))
        return sdf_vjp_fwd(weights, biases, cfg, x, act)

    @staticmethod
    @once_differentiable
    def backward(ctx, c_out, c_grad):
        cfg_items, act, _ = ctx.spec
        x, *wb = ctx.saved_tensors
        n_layers = len(wb) // 2
        weights, biases = wb[:n_layers], wb[n_layers:]
        if c_out is None:
            c_out = torch.zeros(x.shape[0], weights[-1].shape[0], dtype=x.dtype, device=x.device)
        if c_grad is None:
            c_grad = torch.zeros_like(x)
        dWs, dbs, dx = sdf_vjp_bwd(weights, biases, dict(cfg_items), x, c_out, c_grad, act)
        return (None, dx, *dWs, *dbs)


def sdf_value_feat_grad_kernel(net: SDFNetwork, cfg_items: tuple, x: torch.Tensor,
                               act_dtype="float32", fwd_impl: str = "kernel"):
    """Drop-in for ``models.sdf.sdf_value_feat_grad`` in training: (sdf
    (...,), feature (..., d_out - 1), grad (..., 3)), differentiable in
    the SDF net's parameters and in x (``pallas_field_vjp.py:595-639``).
    fwd_impl "kernel" runs K3 forward; "plain" the plain forward (the
    hybrid mode). The backward is K4 + K5 (the plain version on the CPU)."""
    if fwd_impl not in ("kernel", "plain"):
        raise ValueError(f"fwd_impl {fwd_impl!r}")
    cfg = dict(cfg_items)
    shape = x.shape[:-1]
    weights = [layer_weight(net.layer(l)) for l in range(net.n_layers)]
    biases = [layer_bias(net.layer(l)) for l in range(net.n_layers)]
    out, grad = _SDFValueGrad.apply((tuple(sorted(cfg.items())), act_dtype, fwd_impl),
                                    x.reshape(-1, 3), *weights, *biases)
    scale = float(cfg["scale"])
    return (out[:, 0].reshape(shape) / scale, out[:, 1:].reshape(*shape, out.shape[1] - 1),
            grad.reshape(*shape, 3))
