"""Training and serving entry points: the train step, its losses, metrics
and optimiser, and the chunked render of ``make_render_fn``. The exports
are the JAX package's (``neuralrecon_w_tpu/training/__init__.py``) less
``jit_train_step`` (a JAX jit) and ``load_params_subtree`` (orbax)."""

from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .losses import LossConfig, loss_config_from_cfg, loss_terms
from .metrics import mse, psnr, ssim
from .schedule import make_lr_schedule, make_optimizer, scaled_lr
from .step import TrainState, init_state, make_render_fn, make_train_step, ray_mask_from_labels
from .surface import octree_update, surface_level, surface_selection

__all__ = [
    "LossConfig", "loss_config_from_cfg", "loss_terms",
    "mse", "psnr", "ssim",
    "make_lr_schedule", "make_optimizer", "scaled_lr",
    "TrainState", "init_state", "make_render_fn",
    "make_train_step", "ray_mask_from_labels",
    "octree_update", "surface_level", "surface_selection",
    "latest_checkpoint", "restore_checkpoint", "save_checkpoint",
]
