"""The port's Hopper kernels (K1-K12, ``csrc/``), their build, their
wrappers and the plain PyTorch versions beside them."""


def kernel_counters() -> dict:
    """Each kernel's wrapper by its name; the wrapper's ``launches`` counts
    the launches of its kernel (K1's float32 ones also in
    ``fused_sdf_head.launches_f32``)."""
    from .field_forward import fused_field_forward
    from .field_train import field_train_bwd
    from .importance_sampler import up_sample_round
    from .nerf_bg_fused import nerf_bg_bwd, nerf_bg_fwd
    from .ray_voxel import dda_traverse, dda_traverse_hier, sampled_first_hit
    from .sdf_field_vjp import dw_reduce, sdf_vjp_bwd, sdf_vjp_fwd
    from .sdf_mlp import fused_sdf_head

    return {"sdf_mlp": fused_sdf_head, "up_sample": up_sample_round, "sdf_vjp_fwd": sdf_vjp_fwd,
            "sdf_vjp_bwd": sdf_vjp_bwd, "dw_reduce": dw_reduce, "field_fwd": fused_field_forward,
            "field_bwd": field_train_bwd, "nerf_bg_fwd": nerf_bg_fwd, "nerf_bg_bwd": nerf_bg_bwd,
            "dda": dda_traverse, "sampled_hit": sampled_first_hit, "dda_hier": dda_traverse_hier}


def read_launches() -> dict:
    """The counts of ``kernel_counters``, K1's split into ``sdf_mlp_f32``
    and ``sdf_mlp_bf16``."""
    from .sdf_mlp import fused_sdf_head

    got = {n: c.launches for n, c in kernel_counters().items()}
    got["sdf_mlp_f32"] = fused_sdf_head.launches_f32
    got["sdf_mlp_bf16"] = got["sdf_mlp"] - got["sdf_mlp_f32"]
    return got
