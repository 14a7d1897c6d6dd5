"""The system under test, built from the benchmark's inputs through the
port's public entry points: the field (``models/neuconw.NeuconWField``
loading the benchmark's weights strictly), the scene (``rendering/
renderer.SceneInfo``), the grids (``ops/ray_voxel.DeviceGrid``), the
configurations (``config``), and the reference's settings for the same
configuration."""

from __future__ import annotations

import torch

from . import scene as S
from .reference.render import Settings


def scene_inputs(ctx):
    """(SFM grid, fine grid) of the configuration's scene: the grid of the
    SFM points the seed draws, and the shell."""
    a = ctx.cfg["assumed"]
    pts = S.sphere_points(a["sfm_points"], a["sphere_radius"], ctx.generator("scene"))
    sfm = S.sfm_grid(pts, a["bbx_half"], a["sfm_voxel"])
    fine = S.shell_grid(a["fine_level"], a["bbx_half"], a["sphere_radius"], a["shell_half_cells"],
                        ctx.device)
    return sfm, fine


def device_grid(g: S.Grid):
    from neuralrecon_w_tpu_torch.ops.ray_voxel import DeviceGrid

    return DeviceGrid(occ=g.occ, origin=g.origin, scale=g.scale, voxel_size=g.voxel_size)


def scene_info(ctx):
    from neuralrecon_w_tpu_torch.rendering.renderer import SceneInfo

    dev = ctx.device
    return SceneInfo(origin=torch.zeros(3, dtype=torch.float32, device=dev),
                     radius=torch.tensor(float(ctx.cfg["assumed"]["scene_radius"]),
                                         dtype=torch.float32, device=dev),
                     sfm2gt=torch.eye(4, dtype=torch.float32, device=dev))


def ref_scene(ctx):
    """(origin, radius) as the reference takes them."""
    return (torch.zeros(3, dtype=torch.float32, device=ctx.device),
            float(ctx.cfg["assumed"]["scene_radius"]))


def field(ctx, weights: dict, train: bool):
    """The port's field with the benchmark's weights; for serving in eval
    mode without gradients."""
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg
    from neuralrecon_w_tpu_torch.models.neuconw import NeuconWField

    fc = field_config_from_cfg(ctx.port_cfg)
    model = NeuconWField(fc, ctx.device)
    model.load_state_dict(weights, strict=True)
    if not train:
        model.eval().requires_grad_(False)
    return fc, model


def label_ids(ctx, key: str) -> tuple:
    names = ctx.cfg["NEUCONW"][key]
    return tuple(ctx.cfg["label_ids"][x] for x in names) if names else ()


def settings(ctx, train: bool) -> Settings:
    n, tpu = ctx.cfg["NEUCONW"], ctx.cfg["TPU"]
    mesh = n["MESH_MASK_LIST"]
    return Settings(
        n_samples=n["N_SAMPLES"], n_importance=n["N_IMPORTANCE"], up_steps=n["UP_SAMPLE_STEP"],
        n_outside=n["N_OUTSIDE"], s_val_base=n["S_VAL_BASE"],
        boundary=tpu["BOUNDARY_SAMPLES"] if tpu["BOUNDARY_SAMPLES"] >= 0 else n["BOUNDARY_SAMPLES"],
        sample_range=n["SAMPLE_RANGE"], render_bg=n["RENDER_BG"], bg_samples=tpu["BG_SAMPLES"],
        mesh_mask_ids=label_ids(ctx, "MESH_MASK_LIST") if mesh is not None else None,
        surface_samples=tpu["SURFACE_QUERY_SAMPLES"],
        sfm_override=not train and n["NEAR_FAR_OVERRIDE"],
        band="cache" if train else "sampled" if tpu["SURFACE_QUERY"] == "sampled" else "dda")


def free_device() -> None:
    """Every cached block back to the card (a no-op on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
