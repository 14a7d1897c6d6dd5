"""The plain PyTorch version of the SDF-VJP kernels (K3, K4, K5): the SDF
forward with its input gradient, and the hand-derived backward of both.

Port of ``neuralrecon_w_tpu/ops/field_vjp_math.py`` (``forward_with_residuals``,
``backward``), structured the same way: explicit layer loops over tensors,
no autograd anywhere. Weights are in torch's (d_out, d_in) layout, so
``z_l = u_l W_l^T + b_l`` and the reverse sweep is ``r_l = d_l W_l``.

Notation (L layers, c = 1/sqrt 2):

forward F:
    pe = PE(x * s);  u_0 = pe;  l in skip: u_l = [h_l, pe] * c
    z_l = u_l W_l^T + b_l;  h_{l+1} = sp(z_l) (l < L-1);  out = z_{L-1}
input gradient G (reverse sweep):
    d_{L-1} = e_0;  r_l = d_l W_l;  l in skip: r_l -> (a_l, pe part), both * c
    d_{l-1} = a_l * sp'(z_{l-1});  grad = Jpe(xs)^T g_pe

The backward for cotangents (c_out, c_grad) runs the adjoint of G bottom-up
(dW picks up d_l^T r_hat_l; the z2_l = dhat * a_{l+1} * sp''(z_l) second-order
cotangents), then the backward of F top-down with z2 injected (dW picks up
g_tot_l^T u_l), then the PE terms: both Jpe applications and the
x-dependence of Jpe itself (``_pe_jac_x_cot``).

``act_dtype`` rounds as the JAX package's ``_xla_fwd``
(``ops/pallas_field_vjp.py:511-567``) does, and the kernels do: every
operand of a product is rounded to the activation dtype, every product is
summed in float32, biases are added in float32, and the hidden activation
``h = sp(z)`` is rounded before it feeds the next layer. In float32 the
rounding is the identity.
"""

from __future__ import annotations

import math

import torch

_C = 1.0 / math.sqrt(2.0)


def _rnd(t: torch.Tensor, act: torch.dtype) -> torch.Tensor:
    return t if act.itemsize >= 4 else t.to(act).to(t.dtype)


def _mm(a: torch.Tensor, b: torch.Tensor, act: torch.dtype) -> torch.Tensor:
    """a @ b with both operands rounded to act, summed in a's float dtype."""
    return _rnd(a, act) @ _rnd(b, act)


def _sp(z):
    return torch.nn.functional.softplus(z, beta=100.0, threshold=20.0)


# sp is torch's softplus(beta 100, threshold 20): the identity where
# 100 z > 20. Its derivatives follow it there (1 and 0), as autograd's do,
# so the plain version is the derivative of the forward it runs.
def _sp1(z):
    return torch.where(z * 100.0 > 20.0, torch.ones_like(z), torch.sigmoid(z * 100.0))


def _sp2(z):
    sg = torch.sigmoid(z * 100.0)
    return torch.where(z * 100.0 > 20.0, torch.zeros_like(z), 100.0 * sg * (1.0 - sg))


def _pe(xs, multires):
    feats = [xs]
    for i in range(multires):
        feats.append(torch.sin((2.0 ** i) * xs))
        feats.append(torch.cos((2.0 ** i) * xs))
    return torch.cat(feats, dim=-1)


def _pe_jac_T(xs, multires, g_pe):
    """Jpe(xs)^T g_pe -> (N, 3)."""
    out = g_pe[:, :3]
    for i in range(multires):
        f = 2.0 ** i
        s_off, c_off = 3 + 6 * i, 6 + 6 * i
        out = out + g_pe[:, s_off:s_off + 3] * f * torch.cos(f * xs)
        out = out - g_pe[:, c_off:c_off + 3] * f * torch.sin(f * xs)
    return out


def _pe_jac(xs, multires, t):
    """Jpe(xs) t -> (N, pe width)."""
    parts = [t]
    for i in range(multires):
        f = 2.0 ** i
        parts.append(t * f * torch.cos(f * xs))
        parts.append(-t * f * torch.sin(f * xs))
    return torch.cat(parts, dim=-1)


def _pe_jac_x_cot(xs, multires, g_pe, c_grad):
    """x-cotangent from grad = Jpe(xs)^T g_pe's own dependence on xs."""
    dxs = torch.zeros_like(xs)
    for i in range(multires):
        f = 2.0 ** i
        s_off, c_off = 3 + 6 * i, 6 + 6 * i
        dxs = dxs - g_pe[:, s_off:s_off + 3] * (f * f) * torch.sin(f * xs) * c_grad
        dxs = dxs - g_pe[:, c_off:c_off + 3] * (f * f) * torch.cos(f * xs) * c_grad
    return dxs


def _skip_split(r, d_h):
    """A cotangent on the skip input [h, pe] * c -> (h part, pe part)."""
    return r[:, :d_h] * _C, r[:, d_h:] * _C


def forward_with_residuals(weights, biases, skip, multires, scale, x,
                           act=torch.float32) -> dict:
    """Forward and reverse sweep, keeping what the backward needs. Weights
    (d_out, d_in) and biases of the effective (weight-normed) layers."""
    L = len(weights)
    xs = x * scale
    pe = _pe(xs, multires)
    pe_a = _rnd(pe, act)

    us, zs = [], []
    h = pe_a
    for l in range(L):
        u = torch.cat([h, pe_a], dim=-1) * _C if l in skip else h
        us.append(u)
        z = _mm(u, weights[l].t(), act) + biases[l]
        zs.append(z)
        if l < L - 1:
            h = _rnd(_sp(z), act)
    out = zs[-1]

    deltas, a_parts = [None] * L, [None] * L
    deltas[L - 1] = torch.zeros_like(out)
    deltas[L - 1][:, 0] = 1.0
    g_pe = torch.zeros_like(pe)
    pe_w = pe.shape[-1]
    for l in range(L - 1, -1, -1):
        r = _mm(deltas[l], weights[l], act)
        if l in skip:
            a, r_pe = _skip_split(r, r.shape[-1] - pe_w)
            g_pe = g_pe + r_pe
        else:
            a = r
        a_parts[l] = a
        if l > 0:
            deltas[l - 1] = a * _sp1(zs[l - 1])
        else:
            g_pe = g_pe + a
    grad = _pe_jac_T(xs, multires, g_pe)
    return dict(xs=xs, pe=pe, us=us, zs=zs, out=out, deltas=deltas, a_parts=a_parts,
                g_pe=g_pe, grad=grad)


def backward(weights, biases, skip, multires, scale, res, c_out, c_grad,
             act=torch.float32):
    """(dWs (d_out, d_in), dbs, dx) for cotangents c_out on out (N, d_out)
    and c_grad on grad (N, 3)."""
    L = len(weights)
    xs, pe = res["xs"], res["pe"]
    us, zs, deltas, a_parts = res["us"], res["zs"], res["deltas"], res["a_parts"]
    pe_w = pe.shape[-1]
    dWs = [torch.zeros_like(w) for w in weights]
    dbs = [torch.zeros_like(b) for b in biases]

    # ---- adjoint of G (bottom-up) ----
    ghat_pe = _pe_jac(xs, multires, c_grad)  # cotangent on g_pe
    dxs = _pe_jac_x_cot(xs, multires, res["g_pe"], c_grad)
    z2 = [torch.zeros_like(z) for z in zs]
    a_hat = ghat_pe
    for l in range(L):
        if l == 0:
            r_hat = a_hat  # layer 0 is never a skip layer: g_pe += a_0
        else:
            dhat = a_hat  # cotangent on d_{l-1} = a_l * sp'(z_{l-1})
            a_l_hat = dhat * _sp1(zs[l - 1])
            z2[l - 1] = z2[l - 1] + dhat * a_parts[l] * _sp2(zs[l - 1])
            r_hat = torch.cat([a_l_hat * _C, ghat_pe * _C], dim=-1) if l in skip else a_l_hat
        # r_l = d_l W_l: W_l picks up d_l^T r_hat, d_l's cotangent goes on
        dWs[l] = dWs[l] + _mm(deltas[l].t(), r_hat, act)
        if l < L - 1:  # d_{L-1} is the constant seed
            a_hat = _mm(r_hat, weights[l].t(), act)

    # ---- backward of F (top-down) with the z2 injections ----
    gamma = c_out
    pe_hat = torch.zeros_like(pe)
    for l in range(L - 1, -1, -1):
        g_tot = gamma + z2[l]
        dWs[l] = dWs[l] + _mm(g_tot.t(), us[l], act)
        dbs[l] = dbs[l] + g_tot.sum(dim=0)
        beta = _mm(g_tot, weights[l], act)
        if l in skip:
            h_hat, b_pe = _skip_split(beta, beta.shape[-1] - pe_w)
            pe_hat = pe_hat + b_pe
        else:
            h_hat = beta
        if l > 0:
            gamma = h_hat * _sp1(zs[l - 1])
        else:
            pe_hat = pe_hat + h_hat

    dxs = dxs + _pe_jac_T(xs, multires, pe_hat)
    return dWs, dbs, dxs * scale


def value_and_grad(weights, biases, skip, multires, scale, x, act=torch.float32):
    """(out (N, d_out), grad (N, 3)): the plain forward of K3."""
    res = forward_with_residuals(weights, biases, skip, multires, scale, x, act)
    return res["out"], res["grad"]


def vjp(weights, biases, skip, multires, scale, x, c_out, c_grad, act=torch.float32):
    """(dWs, dbs, dx): the plain backward of K4 + K5 (recompute, then the VJP)."""
    res = forward_with_residuals(weights, biases, skip, multires, scale, x, act)
    return backward(weights, biases, skip, multires, scale, res, c_out, c_grad, act)
