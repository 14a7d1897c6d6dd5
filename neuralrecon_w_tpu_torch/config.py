"""Configuration: the cfg tree the port reads, and the static model and
render configuration over it.

The cfg tree is the JAX package's (``neuralrecon_w_tpu/config``): the
same defaults and the same per-scene YAMLs under ``config/``, merged with
the same rules (``_BASE_`` chains, unknown keys refused, values coerced
toward the default's type). The port carries the two sections it reads,
``NEUCONW`` and ``TPU``, so that it imports nothing of the JAX package;
sections it does not read (``DATASET``, ``TRAINER``) are skipped.
``tests/test_torch_config.py`` holds both sections equal to the JAX
package's on every YAML in ``config/``.

``FieldConfig`` and ``RenderConfig`` are the counterparts of
``models/neuconw.py:FieldConfig`` and ``rendering/renderer.py:RenderConfig``.
The TPU-only fields (``sampler_layout``, ``sampler_tile``,
``kernel_tile``, ``remat_field``) stay readable from the cfg but change
nothing here. ``fused_sampler_sdf`` means "run the importance sampler
through its kernels": on CUDA tensors that launches the Hopper kernels,
on CPU tensors their plain versions.
"""

from __future__ import annotations

import ast
import copy
import logging
import os
from typing import NamedTuple, Optional

import yaml

from .datasets.mask_utils import get_label_id_mapping

__all__ = [
    "FieldConfig", "RenderConfig", "field_config_from_cfg",
    "render_config_from_cfg", "get_cfg_defaults", "load_cfg",
]

_SECTIONS = ("NEUCONW", "TPU")
_DEFAULTS = {
    "NEUCONW": {
        "N_SAMPLES": 512, "N_IMPORTANCE": 512, "USE_DISP": False, "PERTURB": 1.0,
        "NOISE_STD": 1.0, "S_VAL_BASE": 0, "BOUNDARY_SAMPLES": 0,
        "NEAR_FAR_OVERRIDE": False, "VOXEL_SIZE": 0.0, "MIN_TRACK_LENGTH": 0,
        "SAMPLE_RANGE": 4, "SDF_THRESHOLD": 1e-3, "TRAIN_VOXEL_SIZE": 0.01,
        "UPDATE_FREQ": 2000, "N_VOCAB": 1500, "ENCODE_A": True, "N_A": 48,
        "N_STATIC_HEAD": 1, "ANNEAL_END": 50000, "RENDER_BG": True, "UP_SAMPLE_STEP": 4,
        "N_OUTSIDE": 32, "MESH_MASK_LIST": None, "RAY_MASK_LIST": None,
        "ENCODE_A_BG": True, "FLOOR_NORMAL": False, "FLOOR_LABELS": ["road"],
        "DEPTH_LOSS": False,
        "SDF_CONFIG": {
            "d_in": 3, "d_out": 513, "d_hidden": 512, "n_layers": 8, "skip_in": (4,),
            "multires": 6, "bias": 0.5, "scale": 1, "geometric_init": True,
            "weight_norm": True, "inside_outside": False,
        },
        "COLOR_CONFIG": {
            "d_in": 9, "d_feature": 512, "mode": "idr", "d_out": 3, "d_hidden": 256,
            "n_layers": 4, "head_channels": 128, "static_head_layers": 2,
            "weight_norm": True, "multires_view": 4,
        },
        "S_CONFIG": {"init_val": 0.03},
        "LOSS": {
            "coef": 1.0, "igr_weight": 0.1, "mask_weight": 0.1, "depth_weight": 0.1,
            "floor_weight": 0.01, "replicate_floor_weight_bug": True,
        },
    },
    "TPU": {
        "MESH_DATA": -1, "MESH_MODEL": 1, "DONATE_STATE": True,
        "FUSED_SAMPLER_SDF": "auto", "DEVICE_POOL": "auto", "POOL_SAMPLING": "epoch",
        "SCAN_INNER": 50, "REMAT_FIELD": False, "SDF_GRAD_MODE": "vjp",
        "FIELD_DTYPE": "float32", "FUSED_BG": False, "BG_SAMPLES": -1,
        "BOUNDARY_SAMPLES": -1, "KERNEL_TILE": -1, "SAMPLER_TILE": -1,
        "SAMPLER_LAYOUT": "lanes", "SURFACE_QUERY": "sampled",
        "SURFACE_QUERY_SAMPLES": 1024,
    },
}


class Cfg(dict):
    """A dict with attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


def _tree(d: dict) -> Cfg:
    return Cfg({k: _tree(v) if isinstance(v, dict) else copy.deepcopy(v) for k, v in d.items()})


def get_cfg_defaults() -> Cfg:
    """A fresh copy of the NEUCONW and TPU defaults."""
    return _tree(_DEFAULTS)


def _coerce(value, old):
    """A YAML value toward the type of its default, as the JAX package's
    ``config/node.py:_coerce`` does."""
    if isinstance(value, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    if old is None or value is None:
        return value
    if isinstance(old, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(old, float) and isinstance(value, (int, str)):
        return float(value)
    if isinstance(old, int) and isinstance(value, str):
        return int(value)
    if isinstance(old, tuple) and isinstance(value, (list, str)):
        if isinstance(value, str):
            value = [int(v) for v in value.strip().strip("()").rstrip(",").split(",") if v.strip()]
        return tuple(value)
    return value


def _merge(src: dict, dst: Cfg, path: str) -> None:
    for key, value in src.items():
        full = f"{path}.{key}"
        if key not in dst:
            raise KeyError(f"non-existent config key: {full}")
        if isinstance(dst[key], Cfg) != isinstance(value, dict):
            raise TypeError(f"config type mismatch at {full}")
        if isinstance(value, dict):
            _merge(value, dst[key], full)
        else:
            dst[key] = _coerce(value, dst[key])


def _merge_file(cfg: Cfg, path: str, seen: tuple) -> None:
    path = os.path.abspath(path)
    if path in seen:
        raise ValueError("_BASE_ include cycle: " + " -> ".join(seen + (path,)))
    with open(path) as f:
        loaded = yaml.safe_load(f) or {}
    base = loaded.pop("_BASE_", None)
    if base is not None:
        _merge_file(cfg, os.path.join(os.path.dirname(path), base), seen + (path,))
    for section in _SECTIONS:
        if section in loaded:
            _merge(loaded[section], cfg[section], section)


def load_cfg(path: str) -> Cfg:
    """Defaults merged with a scene YAML (``_BASE_`` chains included)."""
    cfg = get_cfg_defaults()
    _merge_file(cfg, path, ())
    return cfg


class FieldConfig(NamedTuple):
    """Static model hyperparameters (``models/neuconw.py:31-63``)."""

    sdf: tuple  # sorted (key, value) items of SDF_CONFIG
    color: tuple  # sorted items of COLOR_CONFIG
    s_init: float
    n_vocab: int
    n_a: int
    encode_a: bool
    encode_a_bg: bool
    # only 'vjp' is ported: sdf gradient by one reverse pass (autograd)
    grad_mode: str = "vjp"
    # 'float32' | 'bfloat16' — dtype the hidden activations flow in
    act_dtype: str = "float32"
    # only 'xla' (plain torch) is ported; 'pallas' is a later kernel
    bg_mode: str = "xla"
    # TPU tile override; read from the cfg, unused by the port
    kernel_tile: int = -1

    @property
    def sdf_cfg(self) -> dict:
        return dict(self.sdf)

    @property
    def color_cfg(self) -> dict:
        return dict(self.color)


def field_config_from_cfg(cfg) -> FieldConfig:
    n = cfg.NEUCONW
    fused_bg = getattr(cfg.TPU, "FUSED_BG", False)
    if fused_bg == "auto":  # the fused background kernel is not ported
        fused_bg = False
    return FieldConfig(
        sdf=tuple(sorted(dict(n.SDF_CONFIG).items())),
        color=tuple(sorted(dict(n.COLOR_CONFIG).items())),
        s_init=float(n.S_CONFIG.init_val),
        n_vocab=int(n.N_VOCAB),
        n_a=int(n.N_A),
        encode_a=bool(n.ENCODE_A),
        encode_a_bg=bool(n.ENCODE_A_BG),
        grad_mode=str(getattr(cfg.TPU, "SDF_GRAD_MODE", "vjp")),
        act_dtype=str(getattr(cfg.TPU, "FIELD_DTYPE", "float32")),
        bg_mode="pallas" if fused_bg else "xla",
        kernel_tile=int(getattr(cfg.TPU, "KERNEL_TILE", -1)),
    )


class RenderConfig(NamedTuple):
    """Static rendering hyperparameters (``rendering/renderer.py:34-78``)."""

    n_samples: int = 8
    n_importance: int = 16
    up_sample_steps: int = 2
    n_outside: int = 4
    s_val_base: int = 0
    boundary_samples: int = 10
    sample_range: int = 16
    perturb: float = 1.0
    render_bg: bool = True
    trim_sphere: bool = True
    mesh_mask_ids: Optional[tuple] = None
    floor_normal: bool = False
    floor_label_ids: tuple = ()
    depth_loss: bool = False
    sfm_level: int = -1
    fine_level: int = -1
    nerf_far_override: bool = False
    fused_sampler_sdf: bool = False
    # TPU-only knobs, kept readable; the port ignores them
    remat_field: object = False
    sampler_tile: int = -1
    sampler_layout: str = "lanes"
    surface_query: str = "sampled"
    surface_query_samples: int = 1024
    bg_samples: int = -1


def _checked_bg_samples(bg: int) -> int:
    """TPU.BG_SAMPLES below 8 failed the multi-seed quality ablation
    (docs/bg_boundary_ablation_r5.json); allowed, but warned about."""
    if 0 < bg < 8:
        logging.getLogger(__name__).warning(
            "TPU.BG_SAMPLES=%d is below the quality-validated minimum of "
            "8: the coarse-subset background at %d positions collapses "
            "clean-scene geometry on ~1/3 of training draws (multi-seed "
            "ablation, docs/bg_boundary_ablation_r5.json). Use 8+, or -1 "
            "for the reference behavior.", bg, bg)
    return bg


def render_config_from_cfg(cfg, sfm_level=-1, fine_level=-1,
                           nerf_far_override=None, perturb=None) -> RenderConfig:
    n = cfg.NEUCONW
    # "auto" meant "on a TPU" in the JAX package; here the sampler's
    # wrappers pick kernel or plain version by the tensors' device
    fused = getattr(cfg.TPU, "FUSED_SAMPLER_SDF", False)
    fused = True if fused == "auto" else bool(fused)
    remat = getattr(cfg.TPU, "REMAT_FIELD", False)

    lid = get_label_id_mapping()
    mesh_ids = tuple(lid[x] for x in n.MESH_MASK_LIST) if n.MESH_MASK_LIST else None
    floor_ids = tuple(lid[x] for x in (n.FLOOR_LABELS or []))
    tpu_boundary = int(getattr(cfg.TPU, "BOUNDARY_SAMPLES", -1))
    boundary = tpu_boundary if tpu_boundary >= 0 else int(n.BOUNDARY_SAMPLES)
    return RenderConfig(
        n_samples=int(n.N_SAMPLES),
        n_importance=int(n.N_IMPORTANCE),
        up_sample_steps=int(n.UP_SAMPLE_STEP),
        n_outside=int(n.N_OUTSIDE),
        s_val_base=int(n.S_VAL_BASE),
        boundary_samples=boundary,
        sample_range=int(n.SAMPLE_RANGE),
        perturb=float(n.PERTURB if perturb is None else perturb),
        render_bg=bool(n.RENDER_BG),
        mesh_mask_ids=mesh_ids,
        floor_normal=bool(n.FLOOR_NORMAL),
        floor_label_ids=floor_ids,
        depth_loss=bool(n.DEPTH_LOSS),
        sfm_level=int(sfm_level),
        fine_level=int(fine_level),
        nerf_far_override=bool(
            n.NEAR_FAR_OVERRIDE if nerf_far_override is None else nerf_far_override
        ),
        fused_sampler_sdf=fused,
        remat_field=remat,
        sampler_tile=int(getattr(cfg.TPU, "SAMPLER_TILE", -1)),
        sampler_layout=str(getattr(cfg.TPU, "SAMPLER_LAYOUT", "lanes")),
        surface_query=str(getattr(cfg.TPU, "SURFACE_QUERY", "sampled")),
        surface_query_samples=int(getattr(cfg.TPU, "SURFACE_QUERY_SAMPLES", 1024)),
        bg_samples=_checked_bg_samples(int(getattr(cfg.TPU, "BG_SAMPLES", -1))),
    )
