"""The port's Hopper kernels (K1-K15, ``csrc/``), their build, their
wrappers and the plain PyTorch versions beside them.

Every wrapper can be captured in a ``torch.cuda.CUDAGraph``: it allocates
its outputs and workspace with ``torch.empty`` / ``torch.zeros`` (the
caller's allocator, the graph's pool under capture), packs the weights
from the tensors it is given on every call (so a replay reads the weights
as they are then, after an in-place update), passes the per-layer tables
as host arrays read while the launch is set up, and reads nothing back
to the host; the tile-pass kernels' (K3-K9) launch attributes are set
before each launch (``csrc/sdf_tile.cuh`` ``prepare``), which is no stream
operation and so is legal under capture. A wrapper's ``launches`` ticks
when it issues a launch, eagerly or into a capture: a graph's replays are
not counted."""


def kernel_counters() -> dict:
    """Each kernel's wrapper by its name; the wrapper's ``launches`` counts
    the launches of its kernel (K1's float32 ones also in
    ``fused_sdf_head.launches_f32``)."""
    from .field_forward import fused_field_forward
    from .field_train import field_train_bwd
    from .hash_grid import hash_encode, hash_grad
    from .importance_sampler import up_sample_round
    from .nerf_bg_fused import nerf_bg_bwd, nerf_bg_fwd
    from .ray_voxel import dda_traverse, dda_traverse_hier, sampled_first_hit
    from .sdf_field_vjp import dw_reduce, sdf_vjp_bwd, sdf_vjp_fwd
    from .sdf_mlp import fused_sdf_head
    from .split_tf32 import split_tf32_gemm

    return {"sdf_mlp": fused_sdf_head, "up_sample": up_sample_round, "sdf_vjp_fwd": sdf_vjp_fwd,
            "sdf_vjp_bwd": sdf_vjp_bwd, "dw_reduce": dw_reduce, "field_fwd": fused_field_forward,
            "field_bwd": field_train_bwd, "nerf_bg_fwd": nerf_bg_fwd, "nerf_bg_bwd": nerf_bg_bwd,
            "dda": dda_traverse, "sampled_hit": sampled_first_hit, "dda_hier": dda_traverse_hier,
            "hash_encode": hash_encode, "hash_grad": hash_grad,
            "split_tf32_gemm": split_tf32_gemm}


def reset_launches() -> None:
    """Zero every count ``read_launches`` reads."""
    from .hash_grid import hash_encode
    from .sdf_mlp import fused_sdf_head

    for c in kernel_counters().values():
        c.launches = 0
    fused_sdf_head.launches_f32 = 0
    hash_encode.points = 0


def read_launches() -> dict:
    """The counts of ``kernel_counters``, K1's split into ``sdf_mlp_f32``
    and ``sdf_mlp_bf16``, and the points K13 encoded (``hash_points``)."""
    from .hash_grid import hash_encode
    from .sdf_mlp import fused_sdf_head

    got = {n: c.launches for n, c in kernel_counters().items()}
    got["sdf_mlp_f32"] = fused_sdf_head.launches_f32
    got["sdf_mlp_bf16"] = got["sdf_mlp"] - got["sdf_mlp_f32"]
    got["hash_points"] = hash_encode.points
    return got
