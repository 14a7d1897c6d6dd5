"""Data parallelism over ``torch.distributed`` and the chunked field sweeps
(tensor parallelism over the model axis: ``parallel/tensor.py``).
The exports are the JAX package's (``neuralrecon_w_tpu/parallel/__init__.py``)
where a counterpart exists; the mesh constructors' counterparts are the
group's (``mesh.py``'s docstring)."""

from .mesh import (
    DataGroup,
    all_gather_rows,
    all_reduce_sum_,
    barrier,
    init_data_group,
    is_main,
    pad_to_multiple,
    shard_rays,
    spawn,
    split_for_devices,
)
from .sweep import sharded_rgb_sweep, sharded_sdf_sweep

__all__ = [
    "DataGroup", "all_gather_rows", "all_reduce_sum_", "barrier", "init_data_group",
    "is_main", "pad_to_multiple", "shard_rays", "spawn", "split_for_devices",
    "sharded_rgb_sweep", "sharded_sdf_sweep",
]
