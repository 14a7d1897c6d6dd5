"""A plain reference of Neuralangelo's SDF field, written apart from the
port's code: plain ``torch``, no kernel and no module of the port, float32
with both TF32 switches off (or float64 where a test asks), on a dict of
weights under the field's state-dict names (``neuconw.sdf_net.table``,
``neuconw.sdf_net.lin{l}.weight_v`` / ``weight_g`` / ``bias``).

What it computes, from Li et al., "Neuralangelo: High-Fidelity Neural
Surface Reconstruction" (CVPR 2023) and Mueller et al., "Instant Neural
Graphics Primitives" (SIGGRAPH 2022):

* the hash encoding, by index arithmetic and gathers, in blocks of points
  (``BLOCK``) so that it fits at the benchmark's size;
* the MLP (softplus, beta 100, weight norm), the SDF and the feature;
* the gradient by four tetrahedral taps and the Laplacian, and the
  analytic gradient and Hessian trace by autograd (for the tests);
* the geometry losses (eikonal and curvature, over weighted samples), their
  gradients, the global-norm clip and one AdamW step.

Departures from the published description, each also listed under
``assumed`` in ``benchmark/configs/neuralangelo_op.json``:

* the resolutions are floor(N_min b^l) (floored after a 1e-6 nudge), a
  point's cell c0 = min(floor(u), N_l - 1) at u = (x + B) N_l / (2 B), the
  corners c0 + {0, 1}^3 (tcnn scales by b^l N_min - 1 and offsets by half
  a cell);
* a dense level holds exactly (N_l + 1)^3 entries, indexed c_x + c_y (N_l
  + 1) + c_z (N_l + 1)^2 (tcnn rounds a level's size up to a multiple of
  8);
* the table is float32 (tcnn keeps it in half precision);
* the curvature weight decays as growth^-(levels added since the first
  active count) (the released trainer ties its decay to the same
  schedule); the curvature and eikonal terms are means over the samples
  inside the relaxed sphere of the supervised rays, the port's eikonal
  weighting;
* Adam's epsilon is the system's 1e-7 (torch's AdamW default is 1e-8).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PRIMES = (1, 2654435761, 805459861)
TAPS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
BLOCK = 1 << 18  # points a block of the encoding
SDF = "neuconw.sdf_net."


def resolutions(cfg: dict) -> list:
    levels, lo, hi = int(cfg["levels"]), int(cfg["min_res"]), int(cfg["max_res"])
    if levels == 1:
        return [lo]
    b = math.exp((math.log(hi) - math.log(lo)) / (levels - 1))
    return [int(math.floor(lo * b ** l + 1e-6)) for l in range(levels)]


def layout(cfg: dict) -> list:
    """(resolution, first entry, dense) of each level."""
    t = 1 << int(cfg["log2_table"])
    out, off = [], 0
    for n in resolutions(cfg):
        dense = (n + 1) ** 3 <= t
        out.append((n, off, dense))
        off += (n + 1) ** 3 if dense else t
    return out


def n_entries(cfg: dict) -> int:
    n, off, dense = layout(cfg)[-1]
    return off + ((n + 1) ** 3 if dense else 1 << int(cfg["log2_table"]))


def corner_rows(cfg: dict, level: int, x: torch.Tensor):
    """(P, 8) table rows and (P, 8) trilinear weights of a level's corners
    (corner k: c0 + (k >> 2 & 1, k >> 1 & 1, k & 1)), in x's dtype."""
    n, off, dense = layout(cfg)[level]
    bound = float(cfg["bound"])
    scale = torch.tensor(n / (2.0 * bound), dtype=torch.float32).to(x.dtype)
    u = (torch.clamp(x, -bound, bound) + bound) * scale
    c0 = torch.clamp(torch.floor(u), max=n - 1)
    t = u - c0
    c0 = c0.long()
    mask = (1 << int(cfg["log2_table"])) - 1
    rows, ws = [], []
    for k in range(8):
        b = [(k >> 2) & 1, (k >> 1) & 1, k & 1]
        c = [c0[:, a] + b[a] for a in range(3)]
        w = [t[:, a] if b[a] else 1.0 - t[:, a] for a in range(3)]
        ws.append(w[0] * w[1] * w[2])
        if dense:
            idx = c[0] + c[1] * (n + 1) + c[2] * (n + 1) ** 2
        else:
            idx = ((c[0] * PRIMES[0]) ^ (c[1] * PRIMES[1]) ^ (c[2] * PRIMES[2])) & mask
        rows.append(idx + off)
    return torch.stack(rows, 1), torch.stack(ws, 1)


def encode(cfg: dict, table: torch.Tensor, x: torch.Tensor, active: int,
           touched: torch.Tensor | None = None) -> torch.Tensor:
    """(P, 3) -> (P, L F): each level's blended corners, levels >= active
    times 0; in blocks of BLOCK points. ``touched``, a bool tensor of the
    table's entries, gets the rows the active levels read."""
    outs = []
    for s in range(0, x.shape[0], BLOCK):
        xb = x[s:s + BLOCK]
        feats = []
        for l in range(int(cfg["levels"])):
            rows, w = corner_rows(cfg, l, xb)
            f = (table[rows] * w[..., None].to(table.dtype)).sum(1)
            if l >= active:
                f = f * 0.0
            elif touched is not None:
                touched[rows.reshape(-1)] = True
            feats.append(f)
        outs.append(torch.cat(feats, -1))
    return torch.cat(outs) if outs else x.new_zeros(0, int(cfg["levels"]) * table.shape[1])


def weight(p: dict, name: str) -> torch.Tensor:
    if f"{name}.weight" in p:
        return p[f"{name}.weight"]
    v, g = p[f"{name}.weight_v"], p[f"{name}.weight_g"]
    return v * (g / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True), min=1e-12))


def mlp(p: dict, cfg: dict, x: torch.Tensor, enc: torch.Tensor, linear=None) -> torch.Tensor:
    """[sdf | feature] (P, d_out) of [x, enc]; ``linear(x, w, b)`` computes
    each product (default: x @ w.T + b)."""
    linear = linear or (lambda a, w, b: a @ w.t() + b)
    n = int(cfg["n_layers"]) + 1
    h = torch.cat([x, enc], -1)
    for l in range(n):
        name = f"{SDF}lin{l}"
        h = linear(h, weight(p, name).to(h.dtype), p[f"{name}.bias"].to(h.dtype))
        if l < n - 1:
            h = F.softplus(h, beta=100.0, threshold=20.0)
    return h


def sdf_feature(p: dict, cfg: dict, x: torch.Tensor, active: int, linear=None, touched=None):
    """(sdf (P,), feature (P, d_out - 1))."""
    table = p[f"{SDF}table"].to(x.dtype)
    out = mlp(p, cfg, x, encode(cfg, table, x, active, touched), linear)
    return out[:, 0], out[:, 1:]


def tap_distance(cfg: dict, active: int, dtype=torch.float32) -> torch.Tensor:
    """e = eps / sqrt 3, eps = 1 / N of the last active level, as float32
    arithmetic gives it (the reciprocal rounded, then the division)."""
    inv = torch.tensor(1.0 / resolutions(cfg)[max(active, 1) - 1], dtype=torch.float32)
    return (inv / math.sqrt(3.0)).to(dtype)


def taps(p: dict, cfg: dict, x: torch.Tensor, active: int, laplacian: bool = True,
         linear=None, e=None, touched=None):
    """(sdf, feature, 4-tap gradient (P, 3), Laplacian (P,) or None): f_i =
    sdf(x + e k_i), grad = sum k_i f_i / (4 e), Laplacian = (sum f_i / 2 -
    2 f(x)) / e^2."""
    e = tap_distance(cfg, active, x.dtype) if e is None else e
    k = torch.tensor(TAPS, dtype=x.dtype, device=x.device)
    f0, feat = sdf_feature(p, cfg, x, active, linear, touched)
    f = torch.stack([sdf_feature(p, cfg, x + e * k[i], active, linear, touched)[0]
                     for i in range(4)])
    grad = (f[:, :, None] * k[:, None, :]).sum(0) / (4.0 * e)
    lap = (f.sum(0) * 0.5 - 2.0 * f0) / (e * e) if laplacian else None
    return f0, feat, grad, lap


def analytic(p: dict, cfg: dict, x: torch.Tensor, active: int):
    """(autograd gradient (P, 3), trace of the Hessian (P,)) of the SDF, in
    x's dtype (float64 for the tests)."""
    x = x.detach().clone().requires_grad_(True)
    s, _ = sdf_feature(p, cfg, x, active)
    (g,) = torch.autograd.grad(s.sum(), x, create_graph=True)
    tr = sum(torch.autograd.grad(g[:, a].sum(), x, retain_graph=True)[0][:, a] for a in range(3))
    return g.detach(), tr.detach()


def curvature_decay(cfg: dict, active: int) -> float:
    res = resolutions(cfg)
    growth = (res[-1] / res[0]) ** (1.0 / max(len(res) - 1, 1))
    return growth ** -max(active - max(1, min(int(cfg["init_active"]), len(res))), 0)


def geometry_loss(p: dict, cfg: dict, x: torch.Tensor, w: torch.Tensor, active: int,
                  igr_weight: float) -> dict:
    """Neuralangelo's geometry terms over weighted samples (w: the relaxed
    sphere's 0 / 1 weights): the eikonal term igr_weight x sum w (|grad| -
    1)^2 / sum w on the taps' gradient, the curvature term curvature_weight
    x decay x sum w |Laplacian| / sum w, and their total "loss"."""
    _, _, grad, lap = taps(p, cfg, x, active)
    den = w.sum() + 1e-5
    t = {"normal_loss": igr_weight * torch.sum(w * (torch.linalg.vector_norm(grad, dim=-1)
                                                     - 1.0) ** 2) / den,
         "curvature_loss": float(cfg["curvature_weight"]) * curvature_decay(cfg, active)
         * torch.sum(w * lap.abs()) / den}
    t["loss"] = t["normal_loss"] + t["curvature_loss"]
    return t


def clip_(grads: dict, max_norm: float) -> None:
    """The global-norm clip: g unchanged below the bound, else g / norm x
    bound."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                 for g in grads.values()]))
    if max_norm > 0 and norm >= max_norm:
        for g in grads.values():
            g.mul_(max_norm / norm)


def adamw_step_(p: dict, grads: dict, m: dict, v: dict, t: int, lr: float,
                weight_decay: float, eps: float = 1e-7, betas=(0.9, 0.999)) -> None:
    """One AdamW update in place (decoupled decay p *= 1 - lr wd, then the
    bias-corrected Adam step, eps outside the square root); t counts from
    1."""
    with torch.no_grad():
        for k in grads:
            p[k].mul_(1.0 - lr * weight_decay)
            m[k].mul_(betas[0]).add_(grads[k], alpha=1 - betas[0])
            v[k].mul_(betas[1]).addcmul_(grads[k], grads[k], value=1 - betas[1])
            denom = (v[k] / (1 - betas[1] ** t)).sqrt_().add_(eps)
            p[k].sub_(lr / (1 - betas[0] ** t) * m[k] / denom)
