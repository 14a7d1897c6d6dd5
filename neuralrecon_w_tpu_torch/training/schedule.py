"""Optimiser and learning-rate schedule (``neuralrecon_w_tpu/training/schedule.py``).

LR = CANONICAL_LR * world_batch / CANONICAL_BS unless TRAINER.LR is set;
Adam with the reference's eps 1e-7 (AdamW with WEIGHT_DECAY, SGD with
momentum 0.9), after a global-norm clip at GRAD_CLIP. The clip is written
as optax's ``clip_by_global_norm``: g unchanged below the bound, else
g / norm * bound. ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm
and so scales a little differently. The schedule is a function of the
update count, as optax's: update i (from 0) runs at schedule(i). With
``total_steps`` 0 (what the JAX ``Trainer`` passes) the LR is constant.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-7  # the reference's Adam epsilon (reference utils/__init__.py:24)


def scaled_lr(cfg, world_batch_size: int) -> float:
    t = cfg.TRAINER
    if t.LR is not None:
        return float(t.LR)
    return float(t.CANONICAL_LR) * world_batch_size / float(t.CANONICAL_BS)


def make_lr_schedule(cfg, base_lr: float, total_steps: int):
    """A float, or a function of the update count (``schedule.py:22-39``)."""
    name = (cfg.TRAINER.LR_SCHEDULER or "none").lower()
    if name == "none" or total_steps <= 0:
        return base_lr
    steps = max(total_steps, 1)
    if name == "cosine":
        return lambda count: base_lr * 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
    if name == "steplr":
        bounds = sorted(int(s) for s in (cfg.TRAINER.DECAY_STEP or []))
        gamma = float(cfg.TRAINER.DECAY_GAMMA)
        return lambda count: base_lr * gamma ** sum(count >= b for b in bounds)
    if name == "poly":
        exp = float(cfg.TRAINER.POLY_EXP)
        return lambda count: base_lr * (1.0 - min(max(count, 0), steps) / steps) ** exp
    raise ValueError(f"unknown scheduler {name!r}")


def clip_by_global_norm_(params, max_norm: float) -> None:
    """Scales the gradients in place as optax's clip_by_global_norm does."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    if float(norm) >= max_norm:
        for g in grads:
            g.copy_(g / norm * max_norm)


class Optimizer:
    """A torch optimiser with the clip and the schedule in front of it."""

    def __init__(self, params, torch_opt, schedule, clip: float):
        self.params = list(params)
        self.opt = torch_opt
        self.schedule = schedule
        self.clip = clip
        self.count = 0

    def step(self) -> None:
        if self.clip > 0:
            clip_by_global_norm_(self.params, self.clip)
        lr = self.schedule(self.count) if callable(self.schedule) else self.schedule
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)


class OptimizerSpec:
    """The counterpart of an optax chain: ``init(params)`` makes the state."""

    def __init__(self, name: str, schedule, weight_decay: float, clip: float):
        self.name, self.schedule, self.weight_decay, self.clip = name, schedule, weight_decay, clip

    def init(self, params) -> Optimizer:
        params = list(params)
        lr = 0.0  # Optimizer.step sets each update's rate from the schedule
        if self.name == "adam":
            opt = (torch.optim.AdamW(params, lr=lr, eps=EPS, weight_decay=self.weight_decay)
                   if self.weight_decay > 0 else torch.optim.Adam(params, lr=lr, eps=EPS))
        else:  # sgd
            opt = torch.optim.SGD(params, lr=lr, momentum=0.9)
        return Optimizer(params, opt, self.schedule, self.clip)


def make_optimizer(cfg, world_batch_size: int, total_steps: int = 0):
    """(OptimizerSpec, schedule) (``schedule.py:42-66``)."""
    base_lr = scaled_lr(cfg, world_batch_size)
    schedule = make_lr_schedule(cfg, base_lr, total_steps)
    name = (cfg.TRAINER.OPTIMIZER or "adam").lower()
    if name not in ("adam", "sgd"):
        raise NotImplementedError(f"optimizer {name!r} is not ported (adam, sgd are)")
    wd = float(cfg.TRAINER.WEIGHT_DECAY or 0.0)
    return OptimizerSpec(name, schedule, wd, float(cfg.TRAINER.GRAD_CLIP or 0.0)), schedule
