"""Neuralangelo's hash-grid SDF field on a dict of weights (the field's
state-dict names: ``neuconw.sdf_net.table``, ``neuconw.sdf_net.lin{l}.*``),
every product through a ``Precision``: the multi-resolution hash encoding
by index arithmetic and gathers, in blocks of points; the softplus MLP; the
four tetrahedral taps' gradient and the Laplacian.

A frozen copy of ``neuralrecon_w_tpu_torch/testing/reference_neuralangelo.
py`` (the port's CPU tests hold the port to that file), with what the
benchmark's checks need added: a record of the table entries the encodings
read (``touched``, for the rooflines' least bytes) and the planted faults
(``active`` one level short, a tap's offset mirrored, the table's gradient
broken as a faulty scatter-add would break it: ``table_grad_fault``). Its departures from
the published description are that file's, listed under ``assumed`` in
``benchmark/configs/neuralangelo_op.json``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PRIMES = (1, 2654435761, 805459861)
TAPS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
BLOCK = 1 << 18  # points a block of the encoding
SDF = "neuconw.sdf_net."


def resolutions(sdf: dict) -> list:
    levels, lo, hi = int(sdf["levels"]), int(sdf["min_res"]), int(sdf["max_res"])
    if levels == 1:
        return [lo]
    b = math.exp((math.log(hi) - math.log(lo)) / (levels - 1))
    return [int(math.floor(lo * b ** l + 1e-6)) for l in range(levels)]


def layout(sdf: dict) -> list:
    """(resolution, first entry, dense) of each level."""
    t = 1 << int(sdf["log2_table"])
    out, off = [], 0
    for n in resolutions(sdf):
        dense = (n + 1) ** 3 <= t
        out.append((n, off, dense))
        off += (n + 1) ** 3 if dense else t
    return out


def n_entries(sdf: dict) -> int:
    n, off, dense = layout(sdf)[-1]
    return off + ((n + 1) ** 3 if dense else 1 << int(sdf["log2_table"]))


def corner_rows(sdf: dict, level: int, x: torch.Tensor):
    """(P, 8) table rows and (P, 8) trilinear weights of a level's corners."""
    n, off, dense = layout(sdf)[level]
    bound = float(sdf["bound"])
    scale = float(torch.tensor(n / (2.0 * bound), dtype=torch.float32))
    u = (torch.clamp(x, -bound, bound) + bound) * scale
    c0 = torch.clamp(torch.floor(u), max=n - 1)
    t = u - c0
    c0 = c0.long()
    mask = (1 << int(sdf["log2_table"])) - 1
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


def encode(sdf: dict, table: torch.Tensor, x: torch.Tensor, active: int, touched=None):
    """(P, 3) -> (P, L F), levels >= active times 0, in blocks of BLOCK
    points; ``touched`` (a bool tensor of the table's entries) gets the
    rows the active levels read."""
    outs = []
    for s in range(0, x.shape[0], BLOCK):
        xb = x[s:s + BLOCK]
        feats = []
        for l in range(int(sdf["levels"])):
            rows, w = corner_rows(sdf, l, xb)
            f = (table[rows] * w[..., None]).sum(1)
            if l >= active:
                f = f * 0.0
            elif touched is not None:
                touched[rows.reshape(-1)] = True
            feats.append(f)
        outs.append(torch.cat(feats, -1))
    return torch.cat(outs)


def weight(p: dict, name: str) -> torch.Tensor:
    if f"{name}.weight" in p:
        return p[f"{name}.weight"]
    v, g = p[f"{name}.weight_v"], p[f"{name}.weight_g"]
    return v * (g / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True), min=1e-12))


def sdf_feature(p: dict, sdf: dict, prec, x: torch.Tensor, active: int, touched=None):
    """(sdf (P,), feature (P, d_out - 1)) of [x, enc] through the MLP."""
    n = int(sdf["n_layers"]) + 1
    h = torch.cat([x, encode(sdf, p[f"{SDF}table"], x, active, touched)], -1)
    for l in range(n):
        name = f"{SDF}lin{l}"
        h = prec.linear(h, weight(p, name), p[f"{name}.bias"])
        if l < n - 1:
            h = F.softplus(h, beta=100.0, threshold=20.0)
    return h[:, 0], h[:, 1:]


def tap_distance(sdf: dict, active: int) -> torch.Tensor:
    """e = eps / sqrt 3, eps = 1 / N of the last active level, in float32."""
    inv = torch.tensor(1.0 / resolutions(sdf)[max(active, 1) - 1], dtype=torch.float32)
    return inv / math.sqrt(3.0)


def taps(p: dict, sdf: dict, prec, x: torch.Tensor, active: int, laplacian: bool,
         touched=None, mirrored: int = -1):
    """(sdf, feature, 4-tap gradient (P, 3), Laplacian (P,) or None): f_i =
    sdf(x + e k_i), grad = sum k_i f_i / (4 e), Laplacian = (sum f_i / 2 -
    2 f(x)) / e^2. ``mirrored`` (a fault): that tap evaluated at x - e k_i."""
    e = tap_distance(sdf, active).to(x.device)
    k = torch.tensor(TAPS, dtype=x.dtype, device=x.device)
    f0, feat = sdf_feature(p, sdf, prec, x, active, touched)
    fs = []
    for i in range(4):
        off = -e * k[i] if i == mirrored else e * k[i]
        fs.append(sdf_feature(p, sdf, prec, x + off, active, touched)[0])
    f = torch.stack(fs)
    grad = (f[:, :, None] * k[:, None, :]).sum(0) / (4.0 * e)
    lap = (f.sum(0) * 0.5 - 2.0 * f0) / (e * e) if laplacian else None
    return f0, feat, grad, lap


def table_grad_fault(sdf: dict, g: torch.Tensor, fault: str) -> torch.Tensor:
    """The table's gradient ``g`` as a broken scatter-add leaves it: 'zero'
    (nothing scattered), 'drop<l>' (level l's rows left out), 'shift'
    (each level's rows moved one entry on, its last to its first)."""
    if fault == "zero":
        return torch.zeros_like(g)
    t = 1 << int(sdf["log2_table"])
    spans = [(off, (n + 1) ** 3 if dense else t) for n, off, dense in layout(sdf)]
    out = g.clone()
    if fault == "shift":
        for off, size in spans:
            out[off:off + size] = torch.roll(g[off:off + size], 1, 0)
        return out
    if fault.startswith("drop") and fault[4:].isdigit() and int(fault[4:]) < len(spans):
        off, size = spans[int(fault[4:])]
        out[off:off + size] = 0
        return out
    raise ValueError(f"unknown fault of the table's gradient {fault!r}")


def curvature_decay(sdf: dict, active: int) -> float:
    """growth^-(levels added since init_active), as a float32 value."""
    res = resolutions(sdf)
    growth = (res[-1] / res[0]) ** (1.0 / max(len(res) - 1, 1))
    init = max(1, min(int(sdf["init_active"]), len(res)))
    return float(torch.tensor(growth ** -max(active - init, 0), dtype=torch.float32))
