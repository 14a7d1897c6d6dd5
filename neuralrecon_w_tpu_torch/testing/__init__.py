"""Test fixtures of the port: the synthetic phototourism workspace."""

from .synthetic import make_synthetic_scene, sphere_sdf

__all__ = ["make_synthetic_scene", "sphere_sdf"]
