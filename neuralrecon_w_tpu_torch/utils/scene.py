"""Scene set-up without JAX (``neuralrecon_w_tpu/utils/scene.py``): the
unit-sphere ``SceneInfo`` from a scene config."""

from __future__ import annotations

import numpy as np
import torch

from ..device import default_device
from ..rendering.renderer import SceneInfo


def scene_info(scene_config: dict, device=None) -> SceneInfo:
    """SceneInfo from a scene config (origin, radius, optional sfm2gt), on
    ``device`` (default: the card)."""
    device = default_device(device)
    sfm2gt = scene_config.get("sfm2gt", np.eye(4))
    return SceneInfo(
        origin=torch.as_tensor(np.asarray(scene_config["origin"], np.float32), device=device),
        radius=torch.tensor(float(scene_config["radius"]), dtype=torch.float32, device=device),
        sfm2gt=torch.as_tensor(np.asarray(sfm2gt, np.float32), device=device),
    )
