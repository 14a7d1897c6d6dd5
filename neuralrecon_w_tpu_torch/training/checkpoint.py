"""Checkpoints in the reference's Lightning layout
(``neuralrecon_w_tpu/training/checkpoint.py`` in purpose; reference
train.py:31-36, lightning_modules/neuconw_system.py:376-400).

A ``.ckpt`` file is ``torch.save`` of ``{"state_dict", "global_step",
"epoch"}`` with the reference's parameter names (``tools/convert.py``), so
the port reads the reference's own checkpoints and a JAX checkpoint
exported by ``neuralrecon_w_tpu.tools.convert_torch_ckpt --reverse``, and
the reference's strict loader reads what the port writes. The trainer's
files add two top-level entries that loader does not look at:

  * ``"optimizer"``: the torch optimiser's ``state_dict`` (Adam's moments
    and step per parameter, in ``model.parameters()`` order) and the
    update count the LR schedule reads;
  * ``"fine_grid"``: the surface grid's level, origin, scale and cells,
    which the JAX package writes beside its orbax tree as ``fine_grid.npz``.

A file without them (the reference's, or a parameters-only save) restores
with fresh optimiser state and no fine grid, as the JAX package's restore
does. The trainer names its files ``<ckpt_dir>/step_<N>.ckpt``. The JAX
package's orbax checkpoints are not read here.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from ..device import default_device
from ..models.neuconw import NeuconWField
from ..ops.voxel_grid import VoxelGrid
from ..tools.convert import with_dead_entries, without_dead_entries

_STEP_FILE = re.compile(r"^step_(\d+)\.ckpt$")


def save_checkpoint(path: str, model: NeuconWField, step: int, optimizer=None,
                    fine_grid: VoxelGrid | None = None) -> str:
    """Write ``model``'s parameters as a Lightning-layout ``.ckpt`` file,
    the two entries the reference builds but never runs zero-filled, as
    ``convert_torch_ckpt.py:213-218`` writes them; with ``optimizer`` (the
    port's ``schedule.Optimizer``) its state, with ``fine_grid`` the grid."""
    sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    sd = with_dead_entries(sd, encode_a_bg=not hasattr(model.nerf, "views_linears"))
    ckpt = {"state_dict": sd, "global_step": int(step), "epoch": 0}
    if optimizer is not None:
        ckpt["optimizer"] = {"state": optimizer.opt.state_dict(), "count": int(optimizer.count)}
    if fine_grid is not None:
        ckpt["fine_grid"] = {"level": int(fine_grid.level),
                             "origin": [float(v) for v in np.asarray(fine_grid.origin)],
                             "scale": float(fine_grid.scale),
                             "coords": torch.from_numpy(np.asarray(fine_grid.coords, np.int32))}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str) -> dict:
    """A ``.ckpt`` file's contents: "state_dict" (the reference's names,
    dead entries included), "step", and where the file has them
    "optimizer" and "fine_grid" (a ``VoxelGrid``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    out = {"state_dict": ckpt.get("state_dict", ckpt), "step": int(ckpt.get("global_step", 0))}
    if "optimizer" in ckpt:
        out["optimizer"] = ckpt["optimizer"]
    if "fine_grid" in ckpt:
        g = ckpt["fine_grid"]
        out["fine_grid"] = VoxelGrid(int(g["level"]), np.asarray(g["origin"], np.float64),
                                     float(g["scale"]), g["coords"].numpy().astype(np.int32))
    return out


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The ``step_<N>.ckpt`` of the largest N in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir) if (m := _STEP_FILE.match(name))]
    return os.path.join(ckpt_dir, f"step_{max(steps)}.ckpt") if steps else None


def load_field(path: str, fc, device=None) -> NeuconWField:
    """A NeuconWField from a Lightning-layout ``.ckpt`` file, strictly
    loaded, on ``device`` (default: the card)."""
    sd = restore_checkpoint(path)["state_dict"]
    model = NeuconWField(fc, default_device(device))
    model.load_state_dict(without_dead_entries(sd, fc.encode_a_bg), strict=True)
    return model
