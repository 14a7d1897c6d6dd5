"""The training step and serving's render function
(``neuralrecon_w_tpu/training/step.py``).

``make_train_step`` is ``step.py:54-111`` in PyTorch: render, the loss
terms, one backward, the clip and the optimiser update, on a host
``RayPool`` batch. The cos-anneal ratio is min(1, step / ANNEAL_END); the
semantic ray mask is a weight, not a ray drop. The sampler's jitter draws
from a ``torch.Generator`` seeded from (seed, step); its numbers are not
JAX's ``fold_in``. The on-device scan over many steps
(``make_scan_train_fn``) waits for the device ray pool.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from ..config import FieldConfig, RenderConfig
from ..models.neuconw import NeuconWField
from ..rendering.renderer import render_rays
from ..tools.convert import init_field
from .losses import LossConfig, loss_terms
from .metrics import psnr
from .schedule import Optimizer


@dataclass
class TrainState:
    model: NeuconWField
    optimizer: Optimizer
    step: int = 0


def init_state(fc: FieldConfig, optimizer_spec, generator: torch.Generator,
               device=None) -> TrainState:
    """A fresh field and its optimiser state, on ``device`` (default: the card)."""
    model = init_field(fc, generator, device)
    return TrainState(model, optimizer_spec.init(model.parameters()), 0)


def ray_mask_from_labels(labels: torch.Tensor, ray_mask_ids, dtype=torch.float32):
    """1 for supervised rays, 0 for transient classes (``step.py:44-51``)."""
    mask = torch.ones(labels.shape, dtype=dtype, device=labels.device)
    for mid in ray_mask_ids or ():
        mask = torch.where(labels == mid, torch.zeros_like(mask), mask)
    return mask


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The sampler's generator for one step: seeded from (seed, step)."""
    return torch.Generator(device=device).manual_seed(int(seed) * 1_000_003 + int(step))


def make_train_step(fc: FieldConfig, rcfg: RenderConfig, lcfg: LossConfig,
                    anneal_end: int, ray_mask_ids: tuple = (), seed: int = 0):
    """step_fn(state, scene, batch, fine_grid=None, sfm_grid=None) ->
    (state, aux), updating state in place. batch = {"rays": (R, >= 8),
    "ts": (R,), "labels": (R,), "rgbs": (R, 3)}, numpy or tensors; aux
    holds psnr, s_val and every loss term as detached scalar tensors."""

    def loss_fn(model, scene, batch, rng, cos_anneal, fine_grid, sfm_grid):
        ray_mask = ray_mask_from_labels(batch["labels"], ray_mask_ids)
        results = render_rays(model, fc, rcfg, scene, batch["rays"], batch["ts"],
                              batch["labels"], rng, cos_anneal, fine_grid=fine_grid,
                              sfm_grid=sfm_grid, ray_mask=ray_mask)
        terms = loss_terms(lcfg, results, batch["rgbs"])
        aux = {"psnr": psnr(results["color"], batch["rgbs"], results["ray_mask"][:, None]),
               "s_val": torch.mean(results["s_val"]), **terms}
        return terms["loss"], aux

    def step_fn(state: TrainState, scene, batch: dict, fine_grid=None,
                sfm_grid=None):
        dev = scene.origin.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        cos_anneal = min(1.0, state.step / anneal_end) if anneal_end > 0 else 1.0
        rng = step_generator(seed, state.step, dev)
        state.model.train()
        state.optimizer.zero_grad()
        with record_function("train.render_loss"):
            loss, aux = loss_fn(state.model, scene, batch, rng, cos_anneal, fine_grid, sfm_grid)
        loss.backward()
        with record_function("train.optimizer"):
            state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in aux.items()}

    return step_fn


def make_render_fn(fc: FieldConfig, rcfg: RenderConfig):
    """Deterministic chunk render for image synthesis: perturb 0,
    cos_anneal_ratio 1, no ray mask, no autograd graph kept."""

    def render_chunk(model, scene, rays, ts, labels, rng=None, fine_grid=None, sfm_grid=None):
        with torch.no_grad():
            return render_rays(model, fc, rcfg, scene, rays, ts, labels, rng,
                               cos_anneal_ratio=1.0, fine_grid=fine_grid,
                               sfm_grid=sfm_grid, perturb_overwrite=0.0)

    return render_chunk
