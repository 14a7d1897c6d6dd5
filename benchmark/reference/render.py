"""The NeuS-W renderer and loss: near / far from the SFM grid, the surface
band from the fine grid, stratified samples with the sampler's jitter, the
NeuS importance rounds, boundary samples, the NeRF++ background over a
coarse subset, the foreground with its SDF gradient, compositing, and the
training loss. Copied from the port's ``rendering/renderer.py``,
``rendering/sampling.py`` and ``training/losses.py`` for the
configurations of ``benchmark/configs``."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import grid as grid_q
from . import model as M


class Settings(NamedTuple):
    """What a configuration and a phase fix of a render."""

    n_samples: int
    n_importance: int
    up_steps: int
    n_outside: int
    s_val_base: int
    boundary: int
    sample_range: int
    render_bg: bool
    bg_samples: int
    mesh_mask_ids: Optional[tuple]
    surface_samples: int
    sfm_override: bool  # serving: near / far from the SFM grid
    band: str  # 'cache' (training: the pool's DDA of the raw rays), 'dda' or 'sampled'


# ------------------------------- sampling -------------------------------


def merge_sorted(a, b, pa=None, pb=None):
    """Merge row-sorted (R, Na) and (R, Nb); ties put a first. Payloads
    follow."""
    na, nb = a.shape[-1], b.shape[-1]
    pos_a = (b[..., None, :] < a[..., :, None]).sum(-1) + torch.arange(na, device=a.device)
    pos_b = (a[..., None, :] <= b[..., :, None]).sum(-1) + torch.arange(nb, device=a.device)
    perm = torch.cat([pos_a, pos_b], -1)

    def place(xa, xb):
        out = torch.empty(*xa.shape[:-1], na + nb, dtype=xa.dtype, device=xa.device)
        return out.scatter_(-1, perm, torch.cat([xa, xb], -1))

    return place(a, b) if pa is None else (place(a, b), place(pa, pb))


def sample_pdf(bins, weights, n: int):
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, -1)], -1)
    u = torch.linspace(0.5 / n, 1.0 - 0.5 / n, n, dtype=cdf.dtype, device=cdf.device)
    u = u.expand(*cdf.shape[:-1], n).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_lo, cdf_hi = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b_lo = torch.gather(bins, -1, torch.clamp(below, max=bins.shape[-1] - 1))
    b_hi = torch.gather(bins, -1, torch.clamp(above, max=bins.shape[-1] - 1))
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b_lo + (u - cdf_lo) / denom * (b_hi - b_lo)


def up_sample(rays_o, rays_d, z, sdf, n: int, inv_s: float):
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    radius = torch.linalg.vector_norm(pts, dim=-1)
    inside = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z[:, :-1], z[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    cos = torch.minimum(torch.cat([torch.zeros_like(cos[:, :1]), cos[:, :-1]], -1), cos)
    cos = torch.clamp(cos, -1e3, 0.0) * inside
    dist = next_z - prev_z
    prev_cdf = torch.sigmoid((mid_sdf - cos * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid_sdf + cos * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], -1),
                          -1)[:, :-1]
    return sample_pdf(z, alpha * trans, n)


@torch.no_grad()
def importance(p, cfg, prec, st: Settings, rays_o, rays_d, z):
    sdf_cfg = cfg["SDF_CONFIG"]

    def sdf_at(zz):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * zz[..., None]
        return M.sdf_net(p, sdf_cfg, prec, pts.reshape(-1, 3))[0].view(zz.shape)

    sdf = sdf_at(z)
    per = st.n_importance // st.up_steps
    for i in range(st.up_steps):
        new_z = up_sample(rays_o, rays_d, z, sdf, per, 64.0 * 2 ** (st.s_val_base + i))
        if i + 1 == st.up_steps:
            z = merge_sorted(z, new_z)
        else:
            z, sdf = merge_sorted(z, new_z, sdf, sdf_at(new_z))
    return z


# ------------------------------- passes -------------------------------


def _dists(z, sample_dist):
    return torch.cat([torch.diff(z, dim=-1), sample_dist.expand(z.shape[0], 1)], -1)


def _trans(alpha):
    ones = torch.ones_like(alpha[:, :1])
    return torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-7], -1), -1)[:, :-1]


def bg_eval_idx(bg_samples: int, n_total: int, n_outside: int):
    if not 0 < bg_samples < n_total - n_outside:
        return None
    coarse = np.round(np.linspace(0, n_total - 1, bg_samples)).astype(int)
    return sorted(set(coarse.tolist()) | set(range(n_total - n_outside, n_total)))


def background_pass(p, cfg, prec, st, rays_o, rays_d, z, sample_dist, a):
    batch, n = z.shape
    dists = _dists(z, sample_dist)
    mid = z + dists * 0.5
    ev = bg_eval_idx(st.bg_samples, n, st.n_outside)
    mid_eval = mid if ev is None else mid[:, ev]
    k = mid_eval.shape[1]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_eval[..., None]
    r = torch.clamp(torch.linalg.vector_norm(pts, dim=-1, keepdim=True), 1.0, 1e10)
    pts4 = torch.cat([pts / r, 1.0 / r], -1).reshape(-1, 4)
    def rep(t):  # a row a ray, repeated for its k points
        return t[:, None, :].expand(batch, k, t.shape[-1]).reshape(-1, t.shape[-1])

    density, rgb = M.background(p, cfg["ENCODE_A_BG"], prec, pts4, rep(rays_d),
                                rep(a) if cfg["ENCODE_A_BG"] else None)
    density, rgb = density.reshape(batch, k), rgb.reshape(batch, k, 3)
    if ev is not None:
        fmap = np.argmin(np.abs(np.arange(n)[:, None] - np.asarray(ev)[None, :]), axis=1)
        fmap = torch.as_tensor(fmap, device=z.device)
        density, rgb = density[:, fmap], rgb[:, fmap]
    alpha = 1.0 - torch.exp(-F.softplus(density) * dists)
    return alpha, rgb


def foreground_pass(p, cfg, prec, rays_o, rays_d, z, sample_dist, a, cos_anneal, bg_alpha,
                    bg_rgb, ray_mask, train: bool):
    batch, n = z.shape
    dists = _dists(z, sample_dist)
    mid = z + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid[..., None]
    pts_flat = pts.reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(pts.shape).reshape(-1, 3)
    sdf, feat, grad = M.sdf_grad(p, cfg["SDF_CONFIG"], prec, pts_flat, create_graph=train)
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
    return {"color": color, "depth": depth, "weights_sum": weights_sum,
            "eikonal_sum": torch.sum(relax * grad_err), "relax_sum": torch.sum(relax)}


def render(p, cfg, prec, st: Settings, scene, rays, ts, labels, jitter, cos_anneal, fine,
           sfm=None, ray_mask=None, train: bool = False) -> dict:
    """rays (R, 10) [o, d, near, far, depth, weight] in SFM units; jitter
    (t_rand (R, 1), z_rand (R, n_outside)) uniform draws, or None (no
    perturbation); fine / sfm grids, or None. Returns the colour, depth,
    weights_sum, the eikonal sum and count, mask error and SFM depth
    terms."""
    origin, radius = scene
    batch = rays.shape[0]
    rays_o_sfm_in, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7] / radius, rays[:, 7:8] / radius
    depth_gt, depth_w = rays[:, 8] / radius, rays[:, 9]
    if ray_mask is None:
        ray_mask = torch.ones(batch, dtype=rays.dtype, device=rays.device)
    rays_o = (rays_o_sfm_in - origin) / radius
    a = p["embedding_a.weight"][ts.long()]

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
        z = importance(p, cfg, prec, st, rays_o, rays_d, z)
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
                          bg_rgb, ray_mask, train)
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


def loss_terms(lw: dict, out: dict, rgbs, depth_loss: bool, mesh_mask: bool) -> dict:
    """The weighted colour L1, eikonal, mask BCE and SFM depth terms under
    the port's names, and their total "loss" (``training/losses.py`` at one
    rank)."""
    mask = out["ray_mask"][:, None]
    t = {"color_loss": torch.sum(torch.abs((out["color"] - rgbs) * mask)) / (mask.sum() + 1e-5),
         "normal_loss": lw["igr_weight"] * out["eikonal_sum"] / (out["relax_sum"].detach() + 1e-5)}
    if mesh_mask:
        t["mask_error"] = lw["mask_weight"] * torch.mean(out["mask_error"])
    if depth_loss:
        valid = out["sfm_depth_valid"]
        t["sfm_depth_loss"] = lw["depth_weight"] * torch.sum(out["sfm_depth_sq"] * valid) / (
            valid.sum() + 1e-5)
    t = {k: lw["coef"] * v for k, v in t.items()}
    t["loss"] = sum(t.values())
    return t
