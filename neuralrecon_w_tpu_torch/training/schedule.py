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

from ..parallel.tensor import all_reduce_raw

EPS = 1e-7  # the reference's Adam epsilon (reference utils/__init__.py:24)


def scaled_lr(cfg, world_batch_size: int) -> float:
    t = cfg.TRAINER
    if t.LR is not None:
        return float(t.LR)
    return float(t.CANONICAL_LR) * world_batch_size / float(t.CANONICAL_BS)


class _Schedule:
    """A function of the update count, written once in float64 torch ops:
    of a Python int (the host) it is a float, of a 0-d device tensor (a
    captured step) a float64 tensor on that device."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, count):
        if isinstance(count, torch.Tensor):
            return self.fn(count.double())
        return float(self.fn(torch.tensor(float(count), dtype=torch.float64)))


def make_lr_schedule(cfg, base_lr: float, total_steps: int):
    """A float, or a ``_Schedule`` of the update count (``schedule.py:22-39``)."""
    name = (cfg.TRAINER.LR_SCHEDULER or "none").lower()
    if name == "none" or total_steps <= 0:
        return base_lr
    steps = max(total_steps, 1)
    if name == "cosine":
        return _Schedule(lambda c: base_lr * 0.5 * (
            1.0 + torch.cos(math.pi * torch.clamp(c, max=steps) / steps)))
    if name == "steplr":
        bounds = sorted(int(s) for s in (cfg.TRAINER.DECAY_STEP or []))
        gamma = float(cfg.TRAINER.DECAY_GAMMA)
        return _Schedule(lambda c: base_lr * gamma ** sum(
            ((c >= b).double() for b in bounds), torch.zeros_like(c)))
    if name == "poly":
        exp = float(cfg.TRAINER.POLY_EXP)
        return _Schedule(lambda c: base_lr * (1.0 - torch.clamp(c, 0, steps) / steps) ** exp)
    raise ValueError(f"unknown scheduler {name!r}")


def clip_by_global_norm_(params, max_norm: float) -> None:
    """Scales the gradients in place as optax's clip_by_global_norm does,
    without reading the norm back to the host. With parameters split over
    a model axis (``parallel/tensor.py``) the norm is JAX's over its split
    tree: the split blocks' sums of squares summed over the model ranks,
    and each whole parameter counted once."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    split = [p for p in params if getattr(p, "tp", None) is not None]
    if not split:
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads]))
    else:
        sq = all_reduce_raw(torch.stack([torch.linalg.vector_norm(p.grad) for p in split])
                            .square().sum(), split[0].tp.axis)
        whole = [p.grad for p in params if getattr(p, "tp", None) is None]
        if whole:
            sq = sq + torch.stack([torch.linalg.vector_norm(g) for g in whole]).square().sum()
        norm = torch.sqrt(sq)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class Optimizer:
    """A torch optimiser with the clip and the schedule in front of it.

    ``make_capturable`` turns it, for good, into the form a CUDA graph can
    hold (Adam / AdamW with ``capturable=True``, the LR a device tensor
    that each step writes); ``graph_step`` is the step inside the graph,
    which reads the update count from a device tensor and advances it.
    The host count ``count`` is the caller's to advance after replays."""

    def __init__(self, params, torch_opt, schedule, clip: float):
        self.params = list(params)
        self.opt = torch_opt
        self.schedule = schedule
        self.clip = clip
        self.count = 0
        self.lr_t = None  # the device LR once capturable

    def _lr(self, count):
        return self.schedule(count) if callable(self.schedule) else self.schedule

    def step(self) -> None:
        if self.clip > 0:
            clip_by_global_norm_(self.params, self.clip)
        lr = self._lr(self.count)
        if self.lr_t is not None:
            self.lr_t.fill_(lr)
        else:
            for group in self.opt.param_groups:
                group["lr"] = lr
        self.opt.step()
        self.count += 1

    def make_capturable(self) -> None:
        if self.lr_t is not None:
            return
        if not isinstance(self.opt, (torch.optim.Adam, torch.optim.AdamW)):
            raise ValueError("a captured step needs Adam or AdamW (TRAINER.OPTIMIZER adam)")
        dev = self.params[0].device
        self.lr_t = torch.full((), float(self._lr(self.count)), dtype=torch.float32, device=dev)
        for group in self.opt.param_groups:
            group["capturable"] = True
            group["lr"] = self.lr_t
        for st in self.opt.state.values():
            if "step" in st:
                st["step"] = st["step"].to(device=dev, dtype=torch.float32)

    def graph_step(self, count_t: torch.Tensor) -> None:
        """One update from the device count ``count_t`` (advanced by one)."""
        if self.clip > 0:
            clip_by_global_norm_(self.params, self.clip)
        if callable(self.schedule):
            self.lr_t.copy_(self.schedule(count_t))
        self.opt.step()
        count_t += 1

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """The torch optimiser's state dict as a plain (non-capturable)
        optimiser would hold it: the LR a float, ``capturable`` off."""
        sd = self.opt.state_dict()
        sd["param_groups"] = [{**g, "lr": float(self._lr(max(self.count - 1, 0))),
                               "capturable": False} for g in sd["param_groups"]]
        return sd


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
