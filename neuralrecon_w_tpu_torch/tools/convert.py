"""Weights into the port: from the JAX package's parameter pytree, or
drawn fresh with the same initialisation from a ``torch.Generator``.

``params_from_jax`` goes through the JAX package's host-side
``export_state_dict`` (``tools/convert_torch_ckpt.py:114-182``, which
imports no JAX), so the port's module tree is held to the reference
checkpoint layout. It drops the two dead entries that exporter adds for
the reference's strict loader and the port does not build. It imports
the exporter when called: serving from ``init_field`` weights loads
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import FieldConfig
from ..models.color import init_color_
from ..models.nerf_bg import init_nerf_bg_
from ..models.neuconw import NeuconWField
from ..models.sdf import init_sdf_

_DEAD_PREFIXES = ("neuconw.xyz_encoding_final.",)
_DEAD_BG_VIEWS = "nerf.views_linears.0."


def params_from_jax(np_params: dict) -> dict:
    """JAX parameter pytree (numpy leaves) -> the port's state_dict."""
    from neuralrecon_w_tpu.tools.convert_torch_ckpt import export_state_dict

    sd = export_state_dict(np_params)
    dead = _DEAD_PREFIXES
    if "views0" not in np_params["nerf_bg"]:
        dead = dead + (_DEAD_BG_VIEWS,)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in sd.items() if not k.startswith(dead)
    }


def field_from_jax(np_params: dict, fc: FieldConfig, device=None) -> NeuconWField:
    """A NeuconWField holding the JAX parameters, loaded strictly."""
    model = NeuconWField(fc, device)
    model.load_state_dict(params_from_jax(np_params), strict=True)
    return model


def init_field(fc: FieldConfig, generator: torch.Generator, device=None) -> NeuconWField:
    """Fresh field with the JAX package's initialisation
    (``models/neuconw.py:89-99``): N(0, 1) appearance table, geometric
    SDF init, torch-default linears elsewhere, variance = S_CONFIG.init_val.
    The numbers differ from jax.random's; the distributions are the same."""
    model = NeuconWField(fc, device)
    with torch.no_grad():
        model.embedding_a.weight.copy_(
            torch.randn(fc.n_vocab, fc.n_a, generator=generator).to(model.embedding_a.weight.device))
    init_sdf_(model.neuconw.sdf_net, fc.sdf_cfg, generator)
    init_color_(model.neuconw.color_net, generator)
    init_nerf_bg_(model.nerf, generator)
    return model
