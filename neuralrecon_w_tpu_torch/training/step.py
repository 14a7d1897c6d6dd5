"""Serving's render function (``neuralrecon_w_tpu/training/step.py:224-236``).

Only ``make_render_fn`` is ported; the training step waits for the
backward kernels.
"""

from __future__ import annotations

import torch

from ..config import FieldConfig, RenderConfig
from ..rendering.renderer import render_rays


def make_render_fn(fc: FieldConfig, rcfg: RenderConfig):
    """Deterministic chunk render for image synthesis: perturb 0,
    cos_anneal_ratio 1, no ray mask, no autograd graph kept."""

    def render_chunk(model, scene, rays, ts, labels, rng=None, fine_grid=None, sfm_grid=None):
        with torch.no_grad():
            return render_rays(model, fc, rcfg, scene, rays, ts, labels, rng,
                               cos_anneal_ratio=1.0, fine_grid=fine_grid,
                               sfm_grid=sfm_grid, perturb_overwrite=0.0)

    return render_chunk
