"""Optimiser and learning-rate schedule (``neuralrecon_w_tpu/training/schedule.py``).

LR = CANONICAL_LR * world_batch / CANONICAL_BS unless TRAINER.LR is set.
TRAINER.OPTIMIZER names the update, as JAX's optax chain does:

  * ``adam``: torch's Adam with the reference's eps 1e-7 (AdamW with
    WEIGHT_DECAY);
  * ``sgd``: ``SGD``, optax's ``sgd(momentum=0.9)``;
  * ``radam``: ``RAdam``, optax's ``radam(eps=1e-7)``, not torch's RAdam
    (which adds eps to sqrt(v) before the bias correction and rectifies
    from ro > 5).

WEIGHT_DECAY is read for Adam only, as the JAX package reads it. Each runs
after a global-norm clip at GRAD_CLIP, written as optax's
``clip_by_global_norm``: g unchanged below the bound, else g / norm *
bound. ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and so
scales a little differently. The schedule is a function of the update
count, as optax's: update i (from 0) runs at schedule(i). With
``total_steps`` 0 (what the JAX ``Trainer`` passes) the LR is constant.
``SGD`` and ``RAdam`` take the LR as a float or as a 0-d tensor and read
nothing back to the host, so one code runs an eager step and a captured
one, on the CPU and on the card.
"""

from __future__ import annotations

import math

import torch

from ..parallel.tensor import all_reduce_raw

EPS = 1e-7  # the reference's Adam epsilon (reference utils/__init__.py:24), RAdam's too
MOMENTUM = 0.9  # optax's sgd(momentum=0.9), the JAX package's
B1, B2 = 0.9, 0.999  # optax's radam defaults
RADAM_THRESHOLD = 5.0  # optax's radam: rectify where ro >= 5
OPTIMIZERS = ("adam", "sgd", "radam")


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


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX rounds a Python float constant."""
    return float(torch.tensor(x, dtype=torch.float32))


def _pow32(base: float, t: torch.Tensor) -> torch.Tensor:
    """float32(base) ** t in float32, ``t`` a 0-d tensor: the float64 power
    rounded once. That is XLA's float32 power inside jit (the JAX package's
    train step and scan) to the bit at all but a few counts through 3,000.
    Eager ``jnp.power`` with an integer count squares and multiplies
    instead, an ulp or two off, which moves RAdam's ro by ~0.02 at t = 6."""
    return torch.pow(_f32(base), t.double()).float()


class SGD(torch.optim.Optimizer):
    """optax's ``sgd(lr, momentum=0.9)``: a trace from zero, v = g + 0.9 v
    (so v1 = g1), then p -= lr v. torch's SGD computes the same, but reads a
    tensor LR back to the host, which a CUDA graph cannot hold."""

    def __init__(self, params, lr=0.0):
        super().__init__(params, {"lr": lr})

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            bufs = []
            for p in params:
                st = self.state[p]
                if "momentum_buffer" not in st:
                    st["momentum_buffer"] = torch.zeros_like(p)
                bufs.append(st["momentum_buffer"])
            torch._foreach_mul_(bufs, MOMENTUM)
            torch._foreach_add_(bufs, [p.grad for p in params])
            torch._foreach_sub_(params, torch._foreach_mul(bufs, group["lr"]))


class RAdam(torch.optim.Optimizer):
    """optax's ``radam(lr, eps=1e-7)`` (``scale_by_radam``, then
    ``scale_by_learning_rate``). The moments are Adam's; at update t (from
    1), with ro_inf = 2 / (1 - b2) - 1 and ro = ro_inf - 2 t b2^t /
    (1 - b2^t), the update is r m_hat / (sqrt(v_hat) + eps) where ro >= 5,
    r = sqrt((ro - 4) (ro - 2) ro_inf / ((ro_inf - 4) (ro_inf - 2) ro)),
    else m_hat itself; then p -= lr x update. With b2 0.999 updates 1-5
    take m_hat and update 6 (ro 5.95) the rectified one.

    The scalars are float32, as optax's: ro cancels (1999 - 1998 at t = 1),
    and in float64 r moves by ~1 % at t = 6. They are computed from the
    device count (the state's ``step``), and the branch is a
    ``torch.where`` on (ro >= 5) on the device, so a captured step takes
    either. The state has Adam's keys: ``step``, ``exp_avg``,
    ``exp_avg_sq``."""

    def __init__(self, params, lr=0.0):
        super().__init__(params, {"lr": lr})

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            steps, mus, nus = [], [], []
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                elif st["step"].device != p.device:  # a loaded state's count
                    st["step"] = st["step"].to(device=p.device, dtype=torch.float32)
                steps.append(st["step"])
                mus.append(st["exp_avg"])
                nus.append(st["exp_avg_sq"])
            grads = [p.grad for p in params]
            torch._foreach_mul_(mus, B1)
            torch._foreach_add_(mus, grads, alpha=1 - B1)
            torch._foreach_mul_(nus, B2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - B2)
            torch._foreach_add_(steps, 1)
            t = steps[0]
            b2t = _pow32(B2, t)
            ro_inf = 2.0 / (1.0 - B2) - 1.0
            ro = ro_inf - 2 * t * b2t / (1 - b2t)
            r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                           / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            mu_hat = torch._foreach_div(mus, 1 - _pow32(B1, t))
            den = torch._foreach_div(nus, 1 - b2t)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, EPS)
            rectified = torch._foreach_div(torch._foreach_mul(mu_hat, r), den)
            # optax's where (r is NaN at t 3 and 4, and never taken there);
            # a capture refuses torch._foreach_add_ of a 0-d device tensor
            rect = ro >= RADAM_THRESHOLD
            upd = [torch.where(rect, a, m) for a, m in zip(rectified, mu_hat)]
            torch._foreach_mul_(upd, group["lr"])
            torch._foreach_sub_(params, upd)


class Optimizer:
    """An optimiser (``name``: one of OPTIMIZERS) with the clip and the
    schedule in front of it.

    ``make_capturable`` turns it, for good, into the form a CUDA graph can
    hold: the LR a device tensor that each step writes, every update count
    on the device, Adam / AdamW with ``capturable=True`` (``SGD`` and
    ``RAdam`` need nothing more); ``graph_step`` is the step inside the
    graph, which reads the update count from a device tensor and advances
    it. The host count ``count`` is the caller's to advance after replays."""

    def __init__(self, params, torch_opt, schedule, clip: float, name: str):
        self.params = list(params)
        self.opt = torch_opt
        self.schedule = schedule
        self.clip = clip
        self.name = name
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
        dev = self.params[0].device
        self.lr_t = torch.full((), float(self._lr(self.count)), dtype=torch.float32, device=dev)
        for group in self.opt.param_groups:
            if "capturable" in group:  # torch's Adam / AdamW
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
        """{"name", "state", "count"}: the optimiser's name, the torch
        optimiser's state dict as a plain (non-capturable) one would hold
        it (the LR a float, Adam's ``capturable`` off) and the update count."""
        sd = self.opt.state_dict()
        lr = float(self._lr(max(self.count - 1, 0)))
        sd["param_groups"] = [{**g, "lr": lr, **({"capturable": False} if "capturable" in g
                                                 else {})} for g in sd["param_groups"]]
        return {"name": self.name, "state": sd, "count": int(self.count)}

    def load_state_dict(self, saved: dict) -> None:
        """``state_dict``'s dict back. A file written before the name was
        kept is known by its state: SGD's momentum, else Adam's moments (the
        only two the port then had). A state of another optimiser raises."""
        name = saved.get("name") or next(
            ("sgd" if "momentum_buffer" in st else "adam"
             for st in saved["state"]["state"].values()), self.name)
        if name != self.name:
            raise ValueError(f"the checkpoint holds {name!r} optimiser state; TRAINER.OPTIMIZER "
                             f"is {self.name!r}")
        self.opt.load_state_dict(saved["state"])
        self.count = int(saved["count"])


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
        elif self.name == "sgd":
            opt = SGD(params, lr=lr)
        else:
            opt = RAdam(params, lr=lr)
        return Optimizer(params, opt, self.schedule, self.clip, self.name)


def make_optimizer(cfg, world_batch_size: int, total_steps: int = 0):
    """(OptimizerSpec, schedule) (``schedule.py:42-66``); WEIGHT_DECAY is
    read for Adam only."""
    base_lr = scaled_lr(cfg, world_batch_size)
    schedule = make_lr_schedule(cfg, base_lr, total_steps)
    name = (cfg.TRAINER.OPTIMIZER or "adam").lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}")
    wd = float(cfg.TRAINER.WEIGHT_DECAY or 0.0)
    return OptimizerSpec(name, schedule, wd, float(cfg.TRAINER.GRAD_CLIP or 0.0)), schedule
