"""The renderer, loss and training steps of the reference with Neuralangelo's
hash-grid SDF field (``hashgrid.py``) in the NeuS-W field's place: the
importance rounds on its SDF, the foreground on its four taps' gradient,
the curvature term on its Laplacian (over the eikonal term's samples, its
weight decayed with the active levels), and AdamW (decoupled decay, then
torch's bias-corrected step with eps outside the square root) after the
global-norm clip.

What the NeuS-W reference has and this one shares (the sampling, the
background, the colour head, the compositing, the SFM depth and mask terms)
is taken from ``render.py``, ``model.py`` and ``train.py``; ``importance``,
``foreground_pass``, ``render`` and ``loss_terms`` are copies of
``render.py``'s with the hash field put in. ``Faults`` plants the checks'
faults: the encoding one level short, one tap's offset mirrored, the
table's gradient broken (``hashgrid.table_grad_fault``)."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import grid as grid_q
from . import hashgrid as H
from . import model as M
from .render import Settings, _dists, _trans, background_pass, merge_sorted, up_sample
from .train import BETAS, clip_


class Faults(NamedTuple):
    levels_short: int = 0  # the encoding's active levels less this many
    mirrored: int = -1  # the tap evaluated at x - e k_i
    table_grad: str = ""  # hashgrid.table_grad_fault's fault, every step


class Record:
    """The table entries the encodings read: by every encoding of the first
    step (``all``) and by those the backward reaches (``grad``)."""

    def __init__(self, n: int, device):
        self.all = torch.zeros(n, dtype=torch.bool, device=device)
        self.grad = torch.zeros(n, dtype=torch.bool, device=device)


@torch.no_grad()
def importance(p, cfg, prec, st: Settings, rays_o, rays_d, z, active, rec=None):
    sdf_cfg = cfg["SDF_CONFIG"]

    def sdf_at(zz):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * zz[..., None]
        return H.sdf_feature(p, sdf_cfg, prec, pts.reshape(-1, 3), active,
                             None if rec is None else rec.all)[0].view(zz.shape)

    sdf = sdf_at(z)
    per = st.n_importance // st.up_steps
    for i in range(st.up_steps):
        new_z = up_sample(rays_o, rays_d, z, sdf, per, 64.0 * 2 ** (st.s_val_base + i))
        if i + 1 == st.up_steps:
            z = merge_sorted(z, new_z)
        else:
            z, sdf = merge_sorted(z, new_z, sdf, sdf_at(new_z))
    return z


def foreground_pass(p, cfg, prec, rays_o, rays_d, z, sample_dist, a, cos_anneal, bg_alpha,
                    bg_rgb, ray_mask, train: bool, active: int, faults: Faults, rec=None):
    batch, n = z.shape
    dists = _dists(z, sample_dist)
    mid = z + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid[..., None]
    pts_flat = pts.reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(pts.shape).reshape(-1, 3)
    sdf, feat, grad, lap = H.taps(p, cfg["SDF_CONFIG"], prec, pts_flat, active, train,
                                  None if rec is None else rec.grad, faults.mirrored)
    if rec is not None:
        rec.all |= rec.grad
    a_s = a[:, None, :].expand(batch, n, a.shape[-1]).reshape(-1, a.shape[-1])
    rgb = M.color(p, cfg, prec, pts_flat, grad, dirs, feat, a_s).reshape(batch, n, 3)
    inv_s = M.inv_s(p)
    gradients = grad.reshape(batch, n, 3)
    true_cos = torch.sum(dirs * grad, -1, keepdim=True)
    iter_cos = -(F.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal)
                 + F.relu(-true_cos) * cos_anneal)
    d_flat = dists.reshape(-1, 1)
    prev_cdf = torch.sigmoid((sdf[:, None] - iter_cos * d_flat * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf[:, None] + iter_cos * d_flat * 0.5) * inv_s)
    alpha = torch.clamp(((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).reshape(batch, n),
                        0.0, 1.0)
    pts_norm = torch.linalg.vector_norm(pts, dim=-1)
    inside = (pts_norm < 1.0).to(alpha.dtype)
    relax = (pts_norm < 1.2).to(alpha.dtype)
    depth = torch.sum(alpha * _trans(alpha) * mid, -1)
    alpha = alpha * inside
    rgb = rgb * inside[:, :, None]
    if bg_alpha is not None:
        alpha = torch.cat([alpha * inside + bg_alpha[:, :n] * (1.0 - inside), bg_alpha[:, n:]], -1)
        rgb = torch.cat([rgb * inside[:, :, None] + bg_rgb[:, :n] * (1.0 - inside)[:, :, None],
                         bg_rgb[:, n:]], 1)
    weights = alpha * _trans(alpha)
    weights_sum = torch.sum(weights[:, :n] * inside, -1, keepdim=True)
    color = torch.sum(rgb * weights[:, :, None], 1)
    grad_err = (torch.linalg.vector_norm(gradients, dim=-1) - 1.0) ** 2
    relax = relax * ray_mask[:, None]
    out = {"color": color, "depth": depth, "weights_sum": weights_sum,
           "eikonal_sum": torch.sum(relax * grad_err), "relax_sum": torch.sum(relax)}
    if lap is not None:
        out["curvature_sum"] = torch.sum(relax * lap.reshape(batch, n).abs()) * \
            H.curvature_decay(cfg["SDF_CONFIG"], active)
    return out


def render(p, cfg, prec, st: Settings, scene, rays, ts, labels, jitter, cos_anneal, fine,
           active: int, sfm=None, ray_mask=None, train: bool = False, faults=Faults(),
           rec=None) -> dict:
    """``render.render`` with the hash field at ``active`` levels (a copy:
    the sampling and the passes as there)."""
    origin, radius = scene
    batch = rays.shape[0]
    rays_o_sfm_in, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7] / radius, rays[:, 7:8] / radius
    depth_gt, depth_w = rays[:, 8] / radius, rays[:, 9]
    if ray_mask is None:
        ray_mask = torch.ones(batch, dtype=rays.dtype, device=rays.device)
    rays_o = (rays_o_sfm_in - origin) / radius
    a = p["embedding_a.weight"][ts.long()]
    enc_active = active - faults.levels_short

    with torch.no_grad():
        o_sfm = rays_o * radius + origin
        if st.sfm_override and sfm is not None:
            v_near, v_far, hit = grid_q.near_far(sfm, o_sfm, rays_d)
            hit = hit[:, None]
            near = torch.where(hit, v_near[:, None] / radius, near)
            far = torch.where(hit, (v_far[:, None] + sfm.voxel_size) / radius, far)
        s_near, s_far = near, far
        if fine is not None:
            if st.band in ("cache", "dda"):
                surf, _, hit = grid_q.near_far(fine, rays_o_sfm_in if st.band == "cache"
                                               else o_sfm, rays_d, first_only=True)
            else:
                o_norm = (o_sfm - fine.origin) / fine.scale
                t_first, hit = grid_q.sampled_first_hit(
                    fine, o_norm, rays_d, near[:, 0] * radius / fine.scale,
                    far[:, 0] * radius / fine.scale, st.surface_samples)
                surf = torch.where(hit, t_first * fine.scale, torch.zeros_like(t_first))
            band = st.sample_range * fine.voxel_size
            hit = hit[:, None]
            s_near = torch.where(hit, (surf - band)[:, None] / radius, near)
            s_far = torch.where(hit, (surf + band)[:, None] / radius, far)
        sample_dist = (s_far - s_near) / st.n_samples
        lin = torch.linspace(0.0, 1.0, st.n_samples, device=rays.device)
        z = s_near + (s_far - s_near) * lin[None, :]
        use_bg = st.render_bg and st.n_outside > 0
        if use_bg:
            z_out = torch.linspace(1e-3, 1.0 - 1.0 / (st.n_outside + 1.0), st.n_outside,
                                   device=rays.device).expand(batch, st.n_outside)
        if jitter is not None:
            t_rand, z_rand = jitter
            z = z + (s_far - s_near) * (t_rand - 0.5) * 2.0 / st.n_samples
            if use_bg:
                mids = 0.5 * (z_out[..., 1:] + z_out[..., :-1])
                upper = torch.cat([mids, z_out[..., -1:]], -1)
                lower = torch.cat([z_out[..., :1], mids], -1)
                z_out = lower + (upper - lower) * z_rand
        z = importance(p, cfg, prec, st, rays_o, rays_d, z, enc_active, rec)
        if fine is not None and st.boundary > 0:
            bn = st.boundary // 2
            bf = st.boundary - bn
            near_lin = torch.linspace(0.0, 1.0, bn + 1, device=rays.device)[:-1]
            far_lin = torch.linspace(0.0, 1.0, bf + 1, device=rays.device)[1:]
            b_near = near + (z[:, :1] - near) * near_lin[None, :]
            b_far = z[:, -1:] + (far - z[:, -1:]) * far_lin[None, :]
            b_near = torch.where(z[:, :1] >= near, b_near, torch.flip(b_near, [-1]))
            b_far = torch.where(far >= z[:, -1:], b_far, torch.flip(b_far, [-1]))
            z = merge_sorted(merge_sorted(b_near, z), b_far)

    bg_alpha = bg_rgb = None
    if use_bg:
        z_outside = far / torch.flip(z_out, [-1]) + 1.0 / st.n_samples
        bg_alpha, bg_rgb = background_pass(p, cfg, prec, st, rays_o, rays_d,
                                           merge_sorted(z, z_outside), sample_dist, a)
    out = foreground_pass(p, cfg, prec, rays_o, rays_d, z, sample_dist, a, cos_anneal, bg_alpha,
                          bg_rgb, ray_mask, train, enc_active, faults, rec)
    ws = out["weights_sum"]
    if st.mesh_mask_ids is not None:
        mask = torch.ones_like(ws)
        for mid in st.mesh_mask_ids:
            mask = torch.where(labels[:, None] == mid, torch.zeros_like(mask), mask)
        pw = torch.clamp(ws, 1e-3, 1.0 - 1e-3)
        out["mask_error"] = -(mask * torch.log(pw) + (1.0 - mask) * torch.log(1.0 - pw))
    out["sfm_depth_sq"] = (out["depth"] - depth_gt) ** 2 * depth_w
    out["sfm_depth_valid"] = (depth_w > 0).to(rays.dtype) * ray_mask
    out["ray_mask"] = ray_mask
    return out


def loss_terms(lw: dict, curvature_weight: float, out: dict, rgbs, depth_loss: bool,
               mesh_mask: bool) -> dict:
    """``render.loss_terms`` and the curvature term (the port's
    ``training/losses.py`` at one rank)."""
    mask = out["ray_mask"][:, None]
    den = out["relax_sum"].detach() + 1e-5
    t = {"color_loss": torch.sum(torch.abs((out["color"] - rgbs) * mask)) / (mask.sum() + 1e-5),
         "normal_loss": lw["igr_weight"] * out["eikonal_sum"] / den}
    if "curvature_sum" in out:
        t["curvature_loss"] = curvature_weight * out["curvature_sum"] / den
    if mesh_mask:
        t["mask_error"] = lw["mask_weight"] * torch.mean(out["mask_error"])
    if depth_loss:
        valid = out["sfm_depth_valid"]
        t["sfm_depth_loss"] = lw["depth_weight"] * torch.sum(out["sfm_depth_sq"] * valid) / (
            valid.sum() + 1e-5)
    t = {k: lw["coef"] * v for k, v in t.items()}
    t["loss"] = sum(t.values())
    return t


def levels_at(sdf: dict, step: int) -> int:
    """The active levels at a training step (init_active, one more every
    level_every steps, at most all)."""
    levels = int(sdf["levels"])
    if int(sdf["level_every"]) <= 0:
        return levels
    init = max(1, min(int(sdf["init_active"]), levels))
    return min(levels, init + step // int(sdf["level_every"]))


def steps(params: dict, cfg: dict, prec, st, scene, batches: list, jitters: list, fine,
          step0: int, lr: float, weight_decay: float, eps: float, clip: float,
          ray_mask_ids: tuple, faults=Faults(), record: bool = False):
    """len(batches) steps from ``params``. Returns (each step's loss terms,
    the first step's clipped gradients, the parameters after the last step,
    the table rows any step's gradient reached, and with ``record`` the
    first step's ``Record``)."""
    n = cfg["NEUCONW"]
    sdf = n["SDF_CONFIG"]
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    anneal = int(n["ANNEAL_END"])
    table = f"{H.SDF}table"
    rec = Record(p[table].shape[0], p[table].device) if record else None
    losses, first_grads = [], None
    for i, (batch, jitter) in enumerate(zip(batches, jitters)):
        step = step0 + i
        labels = batch["labels"]
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        for mid in ray_mask_ids:
            mask = torch.where(labels == mid, torch.zeros_like(mask), mask)
        cos = min(1.0, step / anneal) if anneal > 0 else 1.0
        out = render(p, n, prec, st, scene, batch["rays"], batch["ts"], labels, jitter, cos,
                     fine, levels_at(sdf, step), ray_mask=mask, train=True, faults=faults,
                     rec=rec if i == 0 else None)
        terms = loss_terms(n["LOSS"], float(sdf["curvature_weight"]), out, batch["rgbs"],
                           bool(n["DEPTH_LOSS"]), n["MESH_MASK_LIST"] is not None)
        names = list(p)
        gs = torch.autograd.grad(terms["loss"], [p[k] for k in names], allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(p[k])) for k, g in zip(names, gs)}
        if faults.table_grad:
            grads[table] = H.table_grad_fault(sdf, grads[table], faults.table_grad)
        clip_(grads, clip)
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        losses.append({k: float(v.detach()) for k, v in terms.items()})
        t = i + 1
        with torch.no_grad():
            for k in names:
                p[k].mul_(1.0 - lr * weight_decay)
                m[k].mul_(BETAS[0]).add_(grads[k], alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(grads[k], grads[k], value=1 - BETAS[1])
                denom = (v2[k] / (1 - BETAS[1] ** t)).sqrt_().add_(eps)
                p[k].sub_(lr / (1 - BETAS[0] ** t) * m[k] / denom)
        del out, terms, gs, grads
    rows = torch.nonzero((m[table] != 0).any(1))[:, 0]
    return losses, first_grads, {k: v.detach() for k, v in p.items()}, rows, rec
