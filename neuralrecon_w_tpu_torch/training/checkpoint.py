"""Checkpoints in the reference's Lightning layout: ``torch.save`` of
``{"state_dict", "global_step", "epoch"}`` with the reference's parameter
names (``tools/convert.py``), so the port reads the reference's own
checkpoints and a JAX checkpoint exported by ``neuralrecon_w_tpu.tools.
convert_torch_ckpt --reverse``, and the reference's strict loader reads
what the port writes. The JAX package's orbax checkpoints are not read
here. Optimiser state and the fine grid come with the trainer.
"""

from __future__ import annotations

import os

import torch

from ..device import default_device
from ..models.neuconw import NeuconWField
from ..tools.convert import with_dead_entries, without_dead_entries


def save_checkpoint(path: str, model: NeuconWField, step: int) -> str:
    """Write ``model``'s parameters as a Lightning-layout ``.ckpt`` file,
    the two entries the reference builds but never runs zero-filled, as
    ``convert_torch_ckpt.py:213-218`` writes them."""
    sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    sd = with_dead_entries(sd, encode_a_bg=not hasattr(model.nerf, "views_linears"))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state_dict": sd, "global_step": int(step), "epoch": 0}, path)
    return path


def load_field(path: str, fc, device=None) -> NeuconWField:
    """A NeuconWField from a Lightning-layout ``.ckpt`` file, strictly
    loaded, on ``device`` (default: the card)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    model = NeuconWField(fc, default_device(device))
    model.load_state_dict(without_dead_entries(sd, fc.encode_a_bg), strict=True)
    return model
