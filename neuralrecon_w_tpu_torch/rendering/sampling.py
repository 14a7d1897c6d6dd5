"""Hierarchical ray sampling (``neuralrecon_w_tpu/rendering/sampling.py``):
deterministic inverse-CDF draws, NeuS up-sampling rounds and sort-free
merges of row-sorted sample sets. These are also the plain versions the
importance-sampler kernel (``ops/importance_sampler.py``) is held to.
"""

from __future__ import annotations

import torch


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Deterministic inverse-CDF sampling: bins (R, B) sorted, weights
    (R, B-1) -> (R, n_samples), with u = (j + 0.5) / n_samples."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (R, B)

    u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                       dtype=cdf.dtype, device=cdf.device)
    u = u.expand(*cdf.shape[:-1], n_samples).contiguous()

    # count of cdf entries <= u (searchsorted, side="right")
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_lo = torch.gather(cdf, -1, below)
    cdf_hi = torch.gather(cdf, -1, above)
    bins_lo = torch.gather(bins, -1, torch.clamp(below, max=bins.shape[-1] - 1))
    bins_hi = torch.gather(bins, -1, torch.clamp(above, max=bins.shape[-1] - 1))

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_lo) / denom
    return bins_lo + t * (bins_hi - bins_lo)


def up_weights(rays_o, rays_d, z_vals, sdf, inv_s: float) -> torch.Tensor:
    """Section weights (R, n-1) of one NeuS round: section-wise linear SDF,
    cosine clamped with its predecessor (min), clipped to [-1e3, 0] and
    masked to the unit sphere; sigmoid-CDF alpha; transmittance."""
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    radius = torch.linalg.vector_norm(pts, dim=-1)
    inside_sphere = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)

    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)

    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]], dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere

    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)

    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], dim=-1), dim=-1
    )[:, :-1]
    return alpha * trans


def up_sample(rays_o, rays_d, z_vals, sdf, n_importance: int, inv_s: float):
    """One NeuS up-sampling round at a fixed inv_s (``sampling.py:52-86``)."""
    return sample_pdf(z_vals, up_weights(rays_o, rays_d, z_vals, sdf, inv_s), n_importance)


def merge_sorted(a, b, payload_a=None, payload_b=None):
    """Merge row-sorted (R, Na) and (R, Nb) into (R, Na+Nb) without a
    sort; ties put a before b, as a stable sort of cat([a, b]) would.
    Payloads are permuted the same way."""
    na, nb = a.shape[-1], b.shape[-1]
    ar_a = torch.arange(na, device=a.device)
    ar_b = torch.arange(nb, device=a.device)
    # a_i lands after the b strictly below it; b_j after the a at or below it
    pos_a = (b[..., None, :] < a[..., :, None]).sum(-1) + ar_a
    pos_b = (a[..., None, :] <= b[..., :, None]).sum(-1) + ar_b
    perm = torch.cat([pos_a, pos_b], dim=-1)  # destination slot per element

    def place(xa, xb):
        out = torch.empty(*xa.shape[:-1], na + nb, dtype=xa.dtype, device=xa.device)
        return out.scatter_(-1, perm, torch.cat([xa, xb], dim=-1))

    merged = place(a, b)
    if payload_a is None:
        return merged
    return merged, place(payload_a, payload_b)


def cat_z_vals(sdf_fn, rays_o, rays_d, z_vals, new_z_vals, sdf, last: bool):
    """Merge new samples in; evaluate their SDF unless this is the last
    round (``sampling.py:121-132``). sdf_fn maps (R, S, 3) -> (R, S)."""
    if last:
        return merge_sorted(z_vals, new_z_vals), None
    pts = rays_o[:, None, :] + rays_d[:, None, :] * new_z_vals[..., None]
    new_sdf = sdf_fn(pts)
    return merge_sorted(z_vals, new_z_vals, sdf, new_sdf)
