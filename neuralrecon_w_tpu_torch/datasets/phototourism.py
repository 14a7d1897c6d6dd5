"""Phototourism workspace metadata (``neuralrecon_w_tpu/datasets/
phototourism.py:56-60``): the scene's ``config.yaml`` (origin, radius,
sfm2gt, eval_bbx, voxel_size, min_track_length)."""

from __future__ import annotations

import os


def load_scene_config(root_dir: str) -> dict:
    import yaml

    with open(os.path.join(root_dir, "config.yaml")) as f:
        return yaml.safe_load(f)
