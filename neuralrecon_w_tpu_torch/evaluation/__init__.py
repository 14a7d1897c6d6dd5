"""Mesh evaluation against a ground-truth point cloud."""

from .eval_mesh import eval_mesh, eval_mesh_arrays, load_eval_points
from .geometry import (bbx_crop, compute_prf, error_colormap, filtered_sfm_points, nn_distances,
                       sample_mesh_surface, transform_points, voxel_point_crop)

__all__ = ["eval_mesh", "eval_mesh_arrays", "load_eval_points", "bbx_crop", "compute_prf",
           "error_colormap", "filtered_sfm_points", "nn_distances", "sample_mesh_surface",
           "transform_points", "voxel_point_crop"]
