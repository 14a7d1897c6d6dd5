"""Mesh evaluation against a ground-truth point cloud, the reprojection
filter and the metric plots."""

from .eval_mesh import eval_mesh, eval_mesh_arrays, load_eval_points
from .geometry import (bbx_crop, compute_prf, error_colormap, filtered_sfm_points, nn_distances,
                       sample_mesh_surface, transform_points, voxel_point_crop)
from .reproj_filter import (render_hit_codes, reprojection_filter, vertex_voxel_codes,
                            voxelize_points)
from .vis_metrics import save_plot, vis_results

__all__ = ["eval_mesh", "eval_mesh_arrays", "load_eval_points", "bbx_crop", "compute_prf",
           "error_colormap", "filtered_sfm_points", "nn_distances", "sample_mesh_surface",
           "transform_points", "voxel_point_crop", "render_hit_codes", "reprojection_filter",
           "vertex_voxel_codes", "voxelize_points", "save_plot", "vis_results"]
