"""Scene set-up without JAX (``neuralrecon_w_tpu/utils/scene.py``): the
unit-sphere ``SceneInfo`` from a scene config, and the bundle the Trainer,
validation and ``render_cli`` share (reference PhototourismDataset.read_meta
+ NeuconWSystem.get_octree, datasets/phototourism.py:317-462,
lightning_modules/neuconw_system.py:137-184): the parsed workspace, its
SceneInfo and the expand=1 / radius=1 SFM occupancy grid that drives the
validation near / far override and the surface refresh.
"""

from __future__ import annotations

import os
from typing import NamedTuple

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


class SceneBundle(NamedTuple):
    meta: object  # datasets.phototourism.SceneMeta
    scene: SceneInfo
    sfm_grid: object  # ops.voxel_grid.VoxelGrid
    sfm_dgrid: object  # ops.ray_voxel.DeviceGrid


def load_scene_bundle(cfg, img_downscale: int | None = None, device=None) -> SceneBundle:
    """The workspace named by ``cfg.DATASET`` parsed at ``img_downscale``
    (default: the cfg's IMG_DOWNSCALE), with its SceneInfo and SFM grid on
    ``device`` (default: the card)."""
    from ..datasets.phototourism import SCENE_DEFAULTS, load_scene_meta
    from ..ops.ray_voxel import device_grid_from_host
    from ..ops.voxel_grid import grid_from_sfm_points

    device = default_device(device)
    root = cfg.DATASET.ROOT_DIR
    scene_name = os.path.basename(os.path.normpath(root))
    sfm_path = (cfg.DATASET.PHOTOTOURISM.SFM_PATH
                or SCENE_DEFAULTS.get(scene_name, {}).get("sfm_path", "sparse"))
    if img_downscale is None:
        img_downscale = int(cfg.DATASET.PHOTOTOURISM.IMG_DOWNSCALE)
    meta = load_scene_meta(root, img_downscale, sfm_path=sfm_path)
    sc = meta.scene_config
    sfm_grid = grid_from_sfm_points(sc, meta.points3d, sc["min_track_length"], sc["voxel_size"],
                                    expand=1, radius=1.0)
    return SceneBundle(meta, scene_info(sc, device), sfm_grid,
                       device_grid_from_host(sfm_grid, device))


def val_downscale(cfg) -> int:
    """The validation and render resolution divisor: at least 8, as the
    reference forces (reference datasets/phototourism.py:70-71), unless
    TRAINER.VAL_DOWNSCALE names one."""
    vds = int(getattr(cfg.TRAINER, "VAL_DOWNSCALE", -1))
    if vds <= 0:
        vds = max(8, int(cfg.DATASET.PHOTOTOURISM.IMG_DOWNSCALE))
    return vds
