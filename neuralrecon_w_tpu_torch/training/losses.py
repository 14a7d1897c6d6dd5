"""NeuS-W training loss (``neuralrecon_w_tpu/training/losses.py``).

Masked L1 colour, eikonal error * igr_weight, semantic mask BCE *
mask_weight (with MESH_MASK_LIST), SFM depth MSE * depth_weight (with
DEPTH_LOSS), the floor-normal term, and with a hash-grid SDF net its
curvature term (``SDF_CONFIG.curvature_weight``). The reference assigns
``floor_weight = depth_weight``; ``replicate_floor_weight_bug`` (default
True) keeps that for parity. Masked rays stay in the batch with zero weight.
The denominators that depend on the batch are counted apart
(``batch_counts``), so that over a data group they are the global batch's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LossConfig(NamedTuple):
    coef: float = 1.0
    igr_weight: float = 0.1
    mask_weight: float = 0.1
    depth_weight: float = 0.1
    floor_weight: float = 0.01
    use_mesh_mask: bool = False
    use_depth_loss: bool = False
    use_floor_normal: bool = False
    replicate_floor_weight_bug: bool = True
    # the hash-grid SDF net's curvature term (0: none), before its decay
    curvature_weight: float = 0.0


def loss_config_from_cfg(cfg) -> LossConfig:
    n = cfg.NEUCONW
    w = n.LOSS
    return LossConfig(
        coef=float(w.coef),
        igr_weight=float(w.igr_weight),
        mask_weight=float(w.mask_weight),
        depth_weight=float(w.depth_weight),
        floor_weight=float(w.floor_weight),
        use_mesh_mask=n.MESH_MASK_LIST is not None,
        use_depth_loss=bool(n.DEPTH_LOSS),
        use_floor_normal=bool(n.FLOOR_NORMAL),
        replicate_floor_weight_bug=bool(w.replicate_floor_weight_bug),
        curvature_weight=float(n.SDF_CONFIG.get("curvature_weight", 0.0)),
    )


def batch_counts(results: dict) -> torch.Tensor:
    """The counts of this batch that the loss divides by, as one (5,)
    vector without gradient: masked-in rays, the eikonal term's relaxed
    samples (``renderer.py:513-514``), rays with SFM depth, floor rays,
    rays. A data-parallel step sums it over the ranks (``training/step.py``)."""
    mask = results["ray_mask"]
    parts = [torch.sum(mask[:, None]), results["relax_sum"], torch.sum(results["sfm_depth_valid"]),
             results["floor_count"], mask.new_full((), float(mask.shape[0]))]
    return torch.stack([p.float() for p in parts]).detach()


def loss_terms(lcfg: LossConfig, results: dict, rgbs: torch.Tensor, counts: torch.Tensor) -> dict:
    """Per-term losses of a render_rays result against (R, 3) target
    colours; 'loss' is the weighted total (``losses.py:52-84``). ``counts``
    is ``batch_counts`` summed over the ranks of a data group (this batch's
    own without one): each term is this rank's numerator over the global
    batch's count, so the ranks' terms and gradients sum to the global
    batch's (JAX's loss over a data mesh)."""
    masks = results["ray_mask"][:, None]
    mask_sum = counts[0] + 1e-5
    color_error = (results["color"] - rgbs) * masks
    ret = {"color_loss": torch.sum(torch.abs(color_error)) / mask_sum}
    ret["normal_loss"] = lcfg.igr_weight * (results["eikonal_sum"] / (counts[1] + 1e-5))
    if lcfg.curvature_weight and "curvature_sum" in results:
        # |Laplacian| over the eikonal term's samples (Neuralangelo's
        # curvature loss), its weight decayed with the levels added
        ret["curvature_loss"] = lcfg.curvature_weight * (
            results["curvature_sum"] / (counts[1] + 1e-5))
    if lcfg.use_mesh_mask:
        # times this rank's share of the global batch (1.0 exactly at one rank)
        mean = torch.mean(results["mask_error"]) * (masks.shape[0] / counts[4])
        ret["mask_error"] = lcfg.mask_weight * mean
    if lcfg.use_depth_loss:
        valid = results["sfm_depth_valid"]
        sfm = torch.sum(results["sfm_depth_sq"] * valid) / (counts[2] + 1e-5)
        ret["sfm_depth_loss"] = lcfg.depth_weight * sfm
    if lcfg.use_floor_normal:
        fw = lcfg.depth_weight if lcfg.replicate_floor_weight_bug else lcfg.floor_weight
        cnt = torch.clamp(counts[3] * 3.0, min=1.0)
        ret["floor_normal_error"] = fw * torch.sum(results["floor_normal_error"]) / cnt

    ret = {k: lcfg.coef * v for k, v in ret.items()}
    ret["loss"] = sum(ret.values())
    return ret
