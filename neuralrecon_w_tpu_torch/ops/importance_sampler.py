"""The NeuS importance sampler: Hopper kernel K2 (``csrc/up_sample.cu``)
for the per-ray up-sampling rounds, K1 (``ops/sdf_mlp.py``) for the SDF
at the samples, and the plain PyTorch versions of both.

Port of ``neuralrecon_w_tpu/ops/pallas_sampler.py:fused_importance_sampler``,
one Pallas kernel on the TPU. Here the stage is a short sequence of
launches, for ``up_steps`` rounds:

    K1 on the n0 base samples
    K2 round 0: weights at inv_s = 64 * 2^s_val_base, draw n_per
    K1 on the draws
    K2 round 1: merge (samples, draws) with their sdf, weights, draw n_per
    ...
    last round: merge the final draws in -> (R, n0 + n_importance) sorted

The SDF activations never leave K1's shared memory; between launches only
the (R, <= 32) sample rows go through device memory.
"""

from __future__ import annotations

import torch

from ..rendering.sampling import cat_z_vals, merge_sorted, up_sample
from .build import check, kernels, stream_handle
from .sdf_mlp import fused_sdf_head, pack_sdf_weights, sdf_mlp_plain


def up_sample_round_plain(rays_o, rays_d, za, sa, zb, sb, n_draw: int, inv_s: float,
                          last: bool):
    """The plain PyTorch version of K2 (same contract as up_sample_round)."""
    if zb is not None:
        z, s = merge_sorted(za, zb, sa, sb)
    else:
        z, s = za, sa
    new_z = up_sample(rays_o, rays_d, z, s, n_draw, inv_s)
    if last:
        return merge_sorted(z, new_z)
    return z, s, new_z


def up_sample_round(rays_o, rays_d, za, sa, zb, sb, n_draw: int, inv_s: float, last: bool):
    """One round: merge (za, sa) with (zb, sb) (either may be None for
    the first round's b), draw n_draw samples from the NeuS weights at
    inv_s. Returns the merged (z, sdf) and the draws, or on the last round
    the final sorted z with the draws merged in. All float32 (R, ·).
    CPU tensors take the plain version; CUDA tensors launch K2, or raise."""
    if za.device.type == "cpu":
        return up_sample_round_plain(rays_o, rays_d, za, sa, zb, sb, n_draw, inv_s, last)
    if za.device.type != "cuda":
        raise ValueError(f"tensors on {za.device}")
    tensors = [rays_o, rays_d, za, sa] + ([zb, sb] if zb is not None else [])
    if any(t.dtype != torch.float32 or t.device != za.device for t in tensors):
        raise ValueError("up_sample_round takes float32 tensors on one device")
    rays_o, rays_d, za, sa = (t.contiguous() for t in (rays_o, rays_d, za, sa))
    r, na = za.shape
    nb = 0 if zb is None else zb.shape[1]
    if (rays_o.shape != (r, 3) or rays_d.shape != (r, 3) or sa.shape != za.shape
            or (zb is not None and (zb.shape != (r, nb) or sb.shape != zb.shape))):
        raise ValueError("up_sample_round: rays (R, 3), z and sdf rows (R, n) of one R")
    if zb is not None:
        zb, sb = zb.contiguous(), sb.contiguous()
    n = na + nb
    empty = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=za.device)  # noqa: E731
    if last:
        out_z, out_s, out_new = empty(r, n + n_draw), None, None
    else:
        out_z, out_s, out_new = empty(r, n), empty(r, n), empty(r, n_draw)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = kernels().nw_up_sample(
        ptr(rays_o), ptr(rays_d), ptr(za), ptr(sa), na, ptr(zb), ptr(sb), nb,
        n_draw, float(inv_s), int(last), r, ptr(out_z), ptr(out_s), ptr(out_new),
        stream_handle(za.device))
    check("nw_up_sample", err)
    up_sample_round.launches += 1
    return out_z if last else (out_z, out_s, out_new)


up_sample_round.launches = 0


@torch.no_grad()
def fused_importance_sampler(sdf_net, sdf_cfg_items: tuple, rays_o, rays_d, z_base,
                             n_importance: int, up_steps: int, s_val_base: int,
                             act_dtype="float32") -> torch.Tensor:
    """z_base (R, n0) sorted -> (R, n0 + n_importance) sorted samples;
    rays in unit-sphere coordinates (``pallas_sampler.py:389-454``).
    K1 and K2 on CUDA tensors, their plain versions on CPU tensors."""
    if up_steps < 1:
        raise ValueError("up_steps must be at least 1")
    packed = pack_sdf_weights(sdf_net, sdf_cfg_items, act_dtype)
    r = rays_o.shape[0]
    rays_o, rays_d, z_base = rays_o.float(), rays_d.float(), z_base.float()

    def sdf_at(z):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        return fused_sdf_head(packed, pts.reshape(-1, 3)).view(r, -1)

    n_per = n_importance // up_steps
    za, sa, zb, sb = z_base, sdf_at(z_base), None, None
    for i in range(up_steps - 1):
        za, sa, zb = up_sample_round(rays_o, rays_d, za, sa, zb, sb, n_per,
                                     64.0 * 2 ** (s_val_base + i), last=False)
        sb = sdf_at(zb)
    return up_sample_round(rays_o, rays_d, za, sa, zb, sb, n_per,
                           64.0 * 2 ** (s_val_base + up_steps - 1), last=True)


@torch.no_grad()
def importance_sampler_plain(sdf_net, sdf_cfg_items: tuple, rays_o, rays_d, z_base,
                             n_importance: int, up_steps: int, s_val_base: int,
                             act_dtype="float32") -> torch.Tensor:
    """The same stage in plain PyTorch on any device, written as the
    unfused sampler of ``renderer.py:294-306`` (up_sample + cat_z_vals):
    the renderer's path when fused_sampler_sdf is off, and the reference
    the kernels are held to on the card."""
    packed = pack_sdf_weights(sdf_net, sdf_cfg_items, act_dtype)
    rays_o, rays_d, z_vals = rays_o.float(), rays_d.float(), z_base.float()

    def sdf_fn(pts):
        return sdf_mlp_plain(packed, pts.reshape(-1, 3)).view(pts.shape[:-1])

    sdf = sdf_fn(rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None])
    n_per = n_importance // up_steps
    for i in range(up_steps):
        new_z = up_sample(rays_o, rays_d, z_vals, sdf, n_per, 64.0 * 2 ** (s_val_base + i))
        z_vals, sdf = cat_z_vals(sdf_fn, rays_o, rays_d, z_vals, new_z, sdf,
                                 last=i + 1 == up_steps)
    return z_vals
