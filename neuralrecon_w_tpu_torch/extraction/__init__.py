"""SDF isosurface mesh extraction."""

from .mesh import (EvalGrid, MeshData, box_eval_grid, dense_eval_grid, extract_mesh,
                   save_mesh_ply, sparse_eval_grid)

__all__ = ["EvalGrid", "MeshData", "box_eval_grid", "dense_eval_grid", "extract_mesh",
           "save_mesh_ply", "sparse_eval_grid"]
