"""Training steps of the reference: render, loss, one backward, the global
norm clip (optax's ``clip_by_global_norm``: g unchanged below the bound,
else g / norm x bound) and torch's Adam update (bias-corrected moments, eps
outside the square root), as the port's ``training/step.py`` and
``training/schedule.py`` run them at one rank with a constant LR."""

from __future__ import annotations

import torch

from . import render as R

BETAS = (0.9, 0.999)


def clip_(grads: dict, max_norm: float) -> None:
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                 for g in grads.values()]))
    if max_norm > 0 and norm >= max_norm:
        for g in grads.values():
            g.mul_(max_norm / norm)


def steps(params: dict, cfg: dict, prec, st, scene, batches: list, jitters: list, fine,
          step0: int, lr: float, eps: float, clip: float, ray_mask_ids: tuple):
    """len(batches) steps from ``params`` (float32 tensors, left as they
    are). Returns (each step's loss terms, the first step's clipped
    gradients, the parameters after the last step): the terms as dicts of
    floats, the gradients and parameters as dicts of tensors."""
    n = cfg["NEUCONW"]
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    anneal = int(n["ANNEAL_END"])
    losses, first_grads = [], None
    for i, (batch, jitter) in enumerate(zip(batches, jitters)):
        step = step0 + i
        labels = batch["labels"]
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        for mid in ray_mask_ids:
            mask = torch.where(labels == mid, torch.zeros_like(mask), mask)
        cos = min(1.0, step / anneal) if anneal > 0 else 1.0
        out = R.render(p, n, prec, st, scene, batch["rays"], batch["ts"], labels, jitter, cos,
                       fine, ray_mask=mask, train=True)
        terms = R.loss_terms(n["LOSS"], out, batch["rgbs"], bool(n["DEPTH_LOSS"]),
                             n["MESH_MASK_LIST"] is not None)
        total = terms["loss"]
        names = list(p)
        gs = torch.autograd.grad(total, [p[k] for k in names], allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(p[k])) for k, g in zip(names, gs)}
        clip_(grads, clip)
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        losses.append({k: float(v.detach()) for k, v in terms.items()})
        t = i + 1
        with torch.no_grad():
            for k in names:
                m[k].mul_(BETAS[0]).add_(grads[k], alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(grads[k], grads[k], value=1 - BETAS[1])
                denom = (v2[k] / (1 - BETAS[1] ** t)).sqrt_().add_(eps)
                p[k].sub_(lr / (1 - BETAS[0] ** t) * m[k] / denom)
        del out, terms, total, gs, grads
    return losses, first_grads, {k: v.detach() for k, v in p.items()}
