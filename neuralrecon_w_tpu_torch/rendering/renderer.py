"""NeuS-W volume renderer (``neuralrecon_w_tpu/rendering/renderer.py``).

Fixed sample counts (8 uniform + 16 importance + boundary guards + the
background tail), masked reductions instead of dropped rays, and the
sampler under no_grad. Rays arrive in SFM units; everything renders
inside the unit training sphere ((x - origin) / radius).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FieldConfig, RenderConfig
from ..models.neuconw import field_background, field_forward
from ..ops.importance_sampler import importance_plain, importance_rounds
from ..ops.ray_voxel import DeviceGrid, grid_near_far, sampled_first_hit
from ..parallel.tensor import vocab_lookup
from ..tracing import span
from .sampling import merge_sorted


class SceneInfo(NamedTuple):
    """Per-scene normalization, as tensors on the render device."""

    origin: torch.Tensor  # (3,)
    radius: torch.Tensor  # ()
    sfm2gt: torch.Tensor  # (4, 4)


# --------------------------- voxel-guided near/far ---------------------------


def near_far_from_sfm_grid(rcfg, scene, grid: DeviceGrid, rays_o, rays_d, near, far):
    """Near/far override from the SFM grid's DDA (``renderer.py:170-179``);
    unit-sphere units in and out."""
    rays_o_sfm = rays_o * scene.radius + scene.origin
    v_near, v_far, hit = grid_near_far(grid, rcfg.sfm_level, rays_o_sfm, rays_d)
    v_near = v_near[:, None] / scene.radius
    v_far = (v_far[:, None] + grid.voxel_size) / scene.radius
    hit = hit[:, None]
    return torch.where(hit, v_near, near), torch.where(hit, v_far, far), hit


def near_far_from_fine_grid(rcfg, scene, grid: DeviceGrid, rays_o, rays_d, near, far,
                            surf_cache=None):
    """Surface band: first hit of the fine grid +- sample_range voxels,
    cached near/far for rays that miss (``renderer.py:182-224``).
    ``surf_cache``, when given, is the per-ray (surf_t in SFM units, hit)
    pair that ``datasets/cache.DeviceRayPool.attach_surface`` precomputed
    by the exact DDA: the band is a function of (ray, grid) alone, and the
    grid changes only at a surface refresh."""
    rays_o_sfm = rays_o * scene.radius + scene.origin
    if surf_cache is not None:
        surf, hit = surf_cache
    elif rcfg.surface_query == "sampled":
        o_norm = (rays_o_sfm - grid.origin) / grid.scale
        t_lo = near[:, 0] * scene.radius / grid.scale
        t_hi = far[:, 0] * scene.radius / grid.scale
        t_first, hit = sampled_first_hit(grid, rcfg.fine_level, o_norm, rays_d,
                                         t_lo, t_hi, rcfg.surface_query_samples)
        surf = torch.where(hit, t_first * grid.scale, torch.zeros_like(t_first))
    else:
        surf, _, hit = grid_near_far(grid, rcfg.fine_level, rays_o_sfm, rays_d, first_only=True)
    band = rcfg.sample_range * grid.voxel_size
    v_near = (surf - band)[:, None] / scene.radius
    v_far = (surf + band)[:, None] / scene.radius
    hit = hit[:, None]
    return torch.where(hit, v_near, near), torch.where(hit, v_far, far), hit


# ------------------------------- sampler -------------------------------


def importance_stage(model, fc: FieldConfig, rcfg: RenderConfig, rays_o, rays_d, z_vals):
    """NeuS importance sampling at the fixed inv_s schedule: the kernels
    (or, on CPU tensors, their plain versions) when fused_sampler_sdf,
    else the plain stage on any device (``renderer.py:277-306``), over
    the SDF net's ``sdf_fn`` in the field's activation dtype."""
    plain = not rcfg.fused_sampler_sdf
    rounds = importance_plain if plain else importance_rounds
    return rounds(model.neuconw.sdf_net.sdf_fn(fc.act_dtype, plain), rays_o, rays_d, z_vals,
                  rcfg.n_importance, rcfg.up_sample_steps, rcfg.s_val_base)


@torch.no_grad()
def sparse_sampler(model, fc: FieldConfig, rcfg: RenderConfig, scene: SceneInfo,
                   rays_o, rays_d, near, far, rng: Optional[torch.Generator],
                   fine_grid: Optional[DeviceGrid], sfm_grid: Optional[DeviceGrid],
                   perturb: float, surf_cache=None):
    """Foreground z (R, S), background z (R, n_outside) and the per-ray
    base section length (``renderer.py:230-328``)."""
    batch = rays_o.shape[0]
    dev = rays_o.device

    if rcfg.nerf_far_override and sfm_grid is not None:
        near, far, _ = near_far_from_sfm_grid(rcfg, scene, sfm_grid, rays_o, rays_d, near, far)

    sample_near, sample_far = near, far
    if fine_grid is not None:
        sample_near, sample_far, _ = near_far_from_fine_grid(
            rcfg, scene, fine_grid, rays_o, rays_d, near, far, surf_cache)

    sample_dist = (sample_far - sample_near) / rcfg.n_samples
    lin = torch.linspace(0.0, 1.0, rcfg.n_samples, device=dev)
    z_vals = sample_near + (sample_far - sample_near) * lin[None, :]

    z_vals_outside = None
    use_bg = rcfg.render_bg and rcfg.n_outside > 0
    if use_bg:
        z_out = torch.linspace(1e-3, 1.0 - 1.0 / (rcfg.n_outside + 1.0), rcfg.n_outside,
                               device=dev).expand(batch, rcfg.n_outside)

    if perturb > 0:
        def uniform(*shape):
            return torch.rand(*shape, generator=rng, device=rng.device if rng else None).to(dev)

        t_rand = uniform(batch, 1) - 0.5
        z_vals = z_vals + (sample_far - sample_near) * t_rand * 2.0 / rcfg.n_samples
        if use_bg:
            mids = 0.5 * (z_out[..., 1:] + z_out[..., :-1])
            upper = torch.cat([mids, z_out[..., -1:]], dim=-1)
            lower = torch.cat([z_out[..., :1], mids], dim=-1)
            z_out = lower + (upper - lower) * uniform(batch, rcfg.n_outside)

    if use_bg:
        # inverse-depth spacing outside the sphere, from far outward
        z_vals_outside = far / torch.flip(z_out, dims=[-1]) + 1.0 / rcfg.n_samples

    if rcfg.n_importance > 0:
        with span("render.importance", dev):
            z_vals = importance_stage(model, fc, rcfg, rays_o, rays_d, z_vals)

    # boundary guards around the surface band; each block is made
    # ascending (a band that starts before near or ends past far runs
    # its linspace descending; a merge must not see that, or the first
    # refresh renders NaNs), then two sort-free merges
    if fine_grid is not None and rcfg.boundary_samples > 0:
        bn = rcfg.boundary_samples // 2
        bf = rcfg.boundary_samples - bn
        near_lin = torch.linspace(0.0, 1.0, bn + 1, device=dev)[:-1]
        far_lin = torch.linspace(0.0, 1.0, bf + 1, device=dev)[1:]
        bound_near = near + (z_vals[:, :1] - near) * near_lin[None, :]
        bound_far = z_vals[:, -1:] + (far - z_vals[:, -1:]) * far_lin[None, :]
        bound_near = torch.where(z_vals[:, :1] >= near, bound_near, torch.flip(bound_near, [-1]))
        bound_far = torch.where(far >= z_vals[:, -1:], bound_far, torch.flip(bound_far, [-1]))
        z_vals = merge_sorted(merge_sorted(bound_near, z_vals), bound_far)

    return z_vals, z_vals_outside, sample_dist


# ----------------------------- core passes -----------------------------


def _dists(z_vals, sample_dist):
    dists = torch.diff(z_vals, dim=-1)
    return torch.cat([dists, sample_dist.expand(z_vals.shape[0], 1)], dim=-1)


class _PositiveCumprod(torch.autograd.Function):
    """cumprod along the last axis of factors that are never 0. Its backward
    is torch's own for an input without zeros (the reversed cumulative sum
    of grad * output, divided by the input), without torch's test for zeros,
    which reads the device: a step captured in a CUDA graph cannot."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return torch.flip(torch.cumsum(torch.flip(out * grad, [-1]), dim=-1), [-1]).div(x)


def _exclusive_trans(alpha):
    """prod_{k<j} (1 - alpha_k + 1e-7), the compositing transmittance; alpha
    <= 1, so every factor is at least 1e-7."""
    ones = torch.ones_like(alpha[:, :1])
    return _PositiveCumprod.apply(torch.cat([ones, 1.0 - alpha + 1e-7], dim=-1))[:, :-1]


_EVAL_INDEX: dict = {}


def _eval_index(eval_idx: tuple, n: int, device) -> tuple:
    """The background's coarse positions and their nearest-index map back
    to all n positions, as device tensors made once per (eval_idx, n,
    device): a step captured in a CUDA graph must not copy from the host."""
    key = (eval_idx, n, str(device))
    if key not in _EVAL_INDEX:
        ev = np.asarray(eval_idx)
        fmap = np.argmin(np.abs(np.arange(n)[:, None] - ev[None, :]), axis=1)
        _EVAL_INDEX[key] = (torch.as_tensor(ev, device=device),
                            torch.as_tensor(fmap, device=device))
    return _EVAL_INDEX[key]


def render_core_outside(model, fc, rcfg, rays_o, rays_d, z_vals, sample_dist, a_embedded,
                        eval_idx=None):
    """NeRF++ background pass (``renderer.py:334-385``). ``eval_idx``
    restricts the NeRF to a coarse subset of the sorted positions, expanded
    back to all of them by nearest index."""
    batch, n = z_vals.shape
    dists = _dists(z_vals, sample_dist)
    mid_z = z_vals + dists * 0.5

    fmap = None
    if eval_idx is not None and len(eval_idx) < n:
        k = len(eval_idx)
        ev, fmap = _eval_index(tuple(eval_idx), n, z_vals.device)
        mid_eval = mid_z[:, ev]
    else:
        k, mid_eval = n, mid_z

    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_eval[..., None]
    r = torch.clamp(torch.linalg.vector_norm(pts, dim=-1, keepdim=True), 1.0, 1e10)
    pts4 = torch.cat([pts / r, 1.0 / r], dim=-1).reshape(-1, 4)

    density, color = field_background(model, fc, pts4, rays_d, a_embedded, k)
    if fmap is not None:
        density = density.reshape(batch, k)[:, fmap].reshape(-1, 1)
        color = color.reshape(batch, k, 3)[:, fmap].reshape(-1, 3)
    alpha = 1.0 - torch.exp(-F.softplus(density.reshape(batch, n)) * dists)
    weights = alpha * _exclusive_trans(alpha)
    sampled_color = color.reshape(batch, n, 3)
    return {
        "color": torch.sum(weights[:, :, None] * sampled_color, dim=1),
        "sampled_color": sampled_color,
        "alpha": alpha,
        "weights": weights,
    }


def _render_depth(alphas, z_vals):
    return torch.sum(alphas * _exclusive_trans(alphas) * z_vals, dim=-1)


def render_core(model, fc, rcfg, rays_o, rays_d, z_vals, sample_dist, a_embedded,
                cos_anneal_ratio, background_alpha, background_sampled_color,
                background_rgb, ray_mask):
    """Foreground SDF pass + fg/bg compositing (``renderer.py:412-532``)."""
    batch, n = z_vals.shape
    dists = _dists(z_vals, sample_dist)
    mid_z = z_vals + dists * 0.5

    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]  # (R, S, 3)
    pts_flat = pts.reshape(-1, 3)
    dirs_flat = rays_d[:, None, :].expand(pts.shape).reshape(-1, 3)

    # in training the sdf, feature and gradient keep their graph, so the
    # colour and eikonal losses reach the SDF net (serving runs under no_grad)
    rgb_flat, inv_s, sdf_flat, grad_flat, lap_flat = field_forward(
        model, fc, pts_flat, rays_d, a_embedded, n, create_graph=torch.is_grad_enabled(),
        laplacian=True)
    rgb = rgb_flat.reshape(batch, n, 3)
    sdf = sdf_flat.reshape(batch, n)
    gradients = grad_flat.reshape(batch, n, 3)

    true_cos = torch.sum(dirs_flat * grad_flat, dim=-1, keepdim=True)
    iter_cos = -(F.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + F.relu(-true_cos) * cos_anneal_ratio)

    d_flat = dists.reshape(-1, 1)
    est_next = sdf_flat[:, None] + iter_cos * d_flat * 0.5
    est_prev = sdf_flat[:, None] - iter_cos * d_flat * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = torch.clamp(((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).reshape(batch, n),
                        0.0, 1.0)

    pts_norm = torch.linalg.vector_norm(pts, dim=-1)
    inside_sphere = (pts_norm < 1.0).to(alpha.dtype)
    relax_inside = (pts_norm < 1.2).to(alpha.dtype)

    depth = _render_depth(alpha, mid_z)

    alpha = alpha * inside_sphere
    rgb = rgb * inside_sphere[:, :, None]
    alpha_in_sphere = alpha
    sphere_rgb = rgb

    color_bg = None
    if background_alpha is not None:
        alpha = alpha * inside_sphere + background_alpha[:, :n] * (1.0 - inside_sphere)
        alpha = torch.cat([alpha, background_alpha[:, n:]], dim=-1)
        rgb = (rgb * inside_sphere[:, :, None]
               + background_sampled_color[:, :n] * (1.0 - inside_sphere)[:, :, None])
        rgb = torch.cat([rgb, background_sampled_color[:, n:]], dim=1)

        bg_alpha_trim = background_alpha
        if rcfg.trim_sphere:
            bg_alpha_trim = torch.cat(
                [background_alpha[:, :n] * (1.0 - inside_sphere), background_alpha[:, n:]], dim=-1)
        weights_bg = bg_alpha_trim * _exclusive_trans(bg_alpha_trim)
        color_bg = torch.sum(background_sampled_color * weights_bg[:, :, None], dim=1)

    weights = alpha * _exclusive_trans(alpha)
    weights_sum = torch.sum(weights[:, :n] * inside_sphere, dim=-1, keepdim=True)

    weights_sphere = alpha_in_sphere * _exclusive_trans(alpha_in_sphere)
    color_sphere = torch.sum(sphere_rgb * weights_sphere[:, :, None], dim=1)

    normals = torch.sum(gradients * weights[:, :n, None], dim=1)
    color = torch.sum(rgb * weights[:, :, None], dim=1)
    if background_rgb is not None:
        color = color + background_rgb * (1.0 - weights_sum)

    grad_norm_err = (torch.linalg.vector_norm(gradients, dim=-1) - 1.0) ** 2
    relax = relax_inside * ray_mask[:, None]
    # the eikonal term's numerator and count apart too: a data-parallel
    # loss divides the rank's numerator by the count over every rank
    eikonal_sum, relax_sum = torch.sum(relax * grad_norm_err), torch.sum(relax)
    gradient_error = eikonal_sum / (relax_sum + 1e-5)

    out = {
        "color": color,
        "color_sphere": color_sphere,
        "color_bg": color_bg if color_bg is not None else torch.zeros_like(color),
        "sdf": sdf,
        "dists": dists,
        "s_val": 1.0 / inv_s,
        "mid_z_vals": mid_z,
        "weights": weights,
        "weights_sum": weights_sum,
        "cdf": prev_cdf.reshape(batch, n),
        "inside_sphere": inside_sphere,
        "depth": depth,
        "gradient_error": gradient_error,
        "eikonal_sum": eikonal_sum,
        "relax_sum": relax_sum,
        "gradients": gradients,
        "normals": normals,
    }
    if lap_flat is not None:
        # the curvature term's numerator over the eikonal term's samples,
        # its weight decayed with the net's coarse-to-fine state
        out["curvature_sum"] = (torch.sum(relax * lap_flat.reshape(batch, n).abs())
                                * model.curvature_decay())
    return out


# ------------------------------- top level -------------------------------


def bg_eval_idx(rcfg: RenderConfig, n_total: int):
    """Static coarse stride over the sorted positions plus the exact
    n_outside tail, or None for the reference behaviour (TPU.BG_SAMPLES)."""
    if not 0 < rcfg.bg_samples < n_total - rcfg.n_outside:
        return None
    coarse = np.round(np.linspace(0, n_total - 1, rcfg.bg_samples)).astype(int)
    tail = np.arange(n_total - rcfg.n_outside, n_total)
    return tuple(sorted(set(coarse.tolist()) | set(tail.tolist())))


def render_rays(model, fc: FieldConfig, rcfg: RenderConfig, scene: SceneInfo,
                rays: torch.Tensor, ts: torch.Tensor, labels: torch.Tensor,
                rng: Optional[torch.Generator], cos_anneal_ratio,
                fine_grid: Optional[DeviceGrid] = None,
                sfm_grid: Optional[DeviceGrid] = None,
                ray_mask: Optional[torch.Tensor] = None,
                background_rgb: Optional[torch.Tensor] = None,
                perturb_overwrite: float = -1.0, surf_cache=None):
    """Render a ray batch (``renderer.py:538-670``).

    rays: (R, >=8) [o(3), d(3), near, far, (depth, weight)] in SFM units;
    ts: (R,) appearance ids; labels: (R,) semantic labels; surf_cache: the
    pool's per-ray (surf_t, hit) band cache (``near_far_from_fine_grid``).
    ``cos_anneal_ratio`` may be a float or a 0-d tensor on the device."""
    batch = rays.shape[0]
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    if rays.shape[1] >= 10:
        depth_gt, depth_weight = rays[:, 8], rays[:, 9]
    else:
        depth_gt = torch.zeros(batch, dtype=rays.dtype, device=rays.device)
        depth_weight = torch.zeros_like(depth_gt)
    if ray_mask is None:
        ray_mask = torch.ones(batch, dtype=rays.dtype, device=rays.device)

    rays_o = (rays_o - scene.origin) / scene.radius
    near = near / scene.radius
    far = far / scene.radius
    depth_gt = depth_gt / scene.radius

    # the embedding's rows by indexing: its backward is a sorted
    # index_put (deterministic), where nn.Embedding's reads a segment count
    # back from the device, which a captured step cannot; a table split by
    # vocab rows over a model axis sums the ranks' rows
    a_embedded = vocab_lookup(model.embedding_a.weight, ts.long())

    perturb = rcfg.perturb if perturb_overwrite < 0 else perturb_overwrite
    z_vals, z_vals_outside, sample_dist = sparse_sampler(
        model, fc, rcfg, scene, rays_o, rays_d, near, far, rng, fine_grid, sfm_grid, perturb,
        surf_cache)

    background_alpha = None
    background_sampled_color = None
    if rcfg.render_bg and rcfg.n_outside > 0:
        with span("render.background", rays_o.device):
            z_feed = merge_sorted(z_vals, z_vals_outside)
            ret_out = render_core_outside(
                model, fc, rcfg, rays_o, rays_d, z_feed, sample_dist, a_embedded,
                eval_idx=bg_eval_idx(rcfg, z_feed.shape[1]))
        background_sampled_color = ret_out["sampled_color"]
        background_alpha = ret_out["alpha"]

    with span("render.foreground", rays_o.device):
        ret = render_core(model, fc, rcfg, rays_o, rays_d, z_vals, sample_dist, a_embedded,
                          cos_anneal_ratio, background_alpha, background_sampled_color,
                          background_rgb, ray_mask)

    weights_sum = ret["weights_sum"]
    if rcfg.mesh_mask_ids is not None:
        mask = torch.ones_like(weights_sum)
        for mid in rcfg.mesh_mask_ids:
            mask = torch.where(labels[:, None] == mid, torch.zeros_like(mask), mask)
        p = torch.clamp(weights_sum, 1e-3, 1.0 - 1e-3)
        mask_error = -(mask * torch.log(p) + (1.0 - mask) * torch.log(1.0 - p))
    else:
        mask_error = torch.zeros_like(weights_sum)

    if rcfg.floor_normal:
        floor_normal_error, floor_y_error, floor_count = _floor_loss(
            rcfg, scene, labels, ret["normals"], rays_o, rays_d, ret["depth"], ray_mask)
    else:
        floor_normal_error = torch.zeros_like(ret["normals"])
        floor_y_error = torch.zeros_like(ret["normals"])
        floor_count = torch.zeros((), device=rays.device)

    out = {
        "color": ret["color"],
        "color_sphere": ret["color_sphere"],
        "color_bg": ret["color_bg"],
        "s_val": ret["s_val"],
        "cdf_fine": ret["cdf"],
        "gradients": ret["gradients"],
        "mask_error": mask_error,
        "weights": ret["weights"],
        "weights_sum": weights_sum,
        "weights_max": torch.amax(ret["weights"], dim=-1, keepdim=True),
        "gradient_error": ret["gradient_error"],
        "eikonal_sum": ret["eikonal_sum"],
        "relax_sum": ret["relax_sum"],
        "inside_sphere": ret["inside_sphere"],
        "depth": ret["depth"],
        "floor_normal_error": floor_normal_error,
        "floor_y_error": floor_y_error,
        "floor_count": floor_count,
        "sfm_depth_sq": (ret["depth"] - depth_gt) ** 2 * depth_weight,
        "sfm_depth_valid": (depth_weight > 0).to(rays.dtype) * ray_mask,
        "ray_mask": ray_mask,
    }
    if "curvature_sum" in ret:
        out["curvature_sum"] = ret["curvature_sum"]
    return out


def _floor_loss(rcfg, scene, labels, normals, rays_o, rays_d, depth, ray_mask):
    """Floor-normal + floor-height-variance regularizer (``renderer.py:673-694``)."""
    floor_mask = torch.zeros_like(labels, dtype=torch.bool)
    for fid in rcfg.floor_label_ids:
        floor_mask = floor_mask | (labels == fid)
    fm = floor_mask.to(normals.dtype) * ray_mask
    count = torch.sum(fm)
    # sfm2gt[:3, :3]^T e_z, read off as its third row: no host copy of e_z
    gt_n = scene.sfm2gt[2, :3].to(normals.dtype)
    gt_n = gt_n / torch.linalg.vector_norm(gt_n)
    err = torch.abs(normals - gt_n[None, :]) * fm[:, None]
    xyz = rays_o + rays_d * depth[:, None]
    n_el = count * 3
    mean = torch.sum(xyz * fm[:, None]) / torch.clamp(n_el, min=1.0)
    var = torch.sum(((xyz - mean) ** 2) * fm[:, None]) / torch.clamp(n_el - 1.0, min=1.0)
    y_err = torch.where(count > 0, var, torch.zeros_like(var))
    return err, y_err.expand(err.shape), count
