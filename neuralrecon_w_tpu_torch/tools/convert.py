"""Weights into the port: from the JAX package's parameter pytree or from
a reference Lightning state dict.

``export_state_dict`` and ``convert_state_dict`` are the port's copies of
``neuralrecon_w_tpu/tools/convert_torch_ckpt.py:65-182`` (numpy only), held
equal to them by ``tests/test_torch_extraction.py``: the JAX pytree to the
reference checkpoint layout and back. The port's module tree has the
reference's names, less the two entries the reference builds but never
runs, which ``training/checkpoint.without_dead_entries`` drops on the way
in. A fresh field comes from ``models/neuconw.init_field``.

A field split over a model axis starts whole, from any of these, and
``parallel.tensor.shard_field`` keeps each rank's blocks;
``parallel.tensor.gather_field`` gives it back whole, with the reference's
names, for a checkpoint or a comparison.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..config import FieldConfig
from ..models.neuconw import NeuconWField
from ..training.checkpoint import without_dead_entries


# ------------- copies of tools/convert_torch_ckpt.py:45-182 -------------


def _lin(sd, prefix):
    w = sd[f"{prefix}.weight"].numpy()
    return {"w": w.T.copy(), "b": sd[f"{prefix}.bias"].numpy().copy()}


def _wn(sd, prefix):
    return {
        "v": sd[f"{prefix}.weight_v"].numpy().T.copy(),
        "g": sd[f"{prefix}.weight_g"].numpy()[:, 0].copy(),
        "b": sd[f"{prefix}.bias"].numpy().copy(),
    }


def _count(sd, pattern):
    """Highest index N matched by pattern's single (\\d+) group, +1."""
    rx = re.compile(pattern)
    idxs = [int(m.group(1)) for k in sd if (m := rx.match(k))]
    return max(idxs) + 1 if idxs else 0


def convert_state_dict(sd: dict) -> dict:
    """Reference Lightning state_dict (torch tensors) -> the JAX package's
    params pytree (numpy leaves). Infers layer counts from the keys."""
    params: dict = {}
    params["embedding_a"] = sd["embedding_a.weight"].numpy().copy()

    n_sdf = _count(sd, r"neuconw\.sdf_net\.lin(\d+)\.weight_v")
    sdf = {f"lin{l}": _wn(sd, f"neuconw.sdf_net.lin{l}") for l in range(n_sdf)}

    n_col = _count(sd, r"neuconw\.color_net\.lin(\d+)\.weight_v")
    color = {f"lin{l}": _wn(sd, f"neuconw.color_net.lin{l}") for l in range(n_col)}
    if "neuconw.color_net.xyz_encoding_final.weight" in sd:
        color["xyz_final"] = _lin(sd, "neuconw.color_net.xyz_encoding_final")
        n_static = _count(sd, r"neuconw\.color_net\.static_encoding\.static_linear_(\d+)\.weight")
        for s in range(n_static):
            color[f"static{s}"] = _lin(sd, f"neuconw.color_net.static_encoding.static_linear_{s}")

    params["neuconw"] = {
        "sdf": sdf,
        "color": color,
        "variance": sd["neuconw.deviation_network.variance"].numpy().reshape(()).copy(),
    }

    n_pts = _count(sd, r"nerf\.pts_linears\.(\d+)\.weight")
    bg = {f"pts{i}": _lin(sd, f"nerf.pts_linears.{i}") for i in range(n_pts)}
    bg["alpha"] = _lin(sd, "nerf.alpha_linear")
    bg["feature"] = _lin(sd, "nerf.feature_linear")
    n_app = _count(sd, r"nerf\.apperence_encoding\.static_linear_(\d+)\.weight")
    if n_app:  # ENCODE_A_BG=True checkpoints
        for s in range(n_app):
            bg[f"app{s}"] = _lin(sd, f"nerf.apperence_encoding.static_linear_{s}")
    else:  # indoor configs: plain view branch
        bg["views0"] = _lin(sd, "nerf.views_linears.0")
    bg["rgb"] = _lin(sd, "nerf.rgb_linear")
    params["nerf_bg"] = bg
    return params


def export_state_dict(params: dict, bg_dir_dim: int = 27) -> dict:
    """The JAX params pytree -> reference Lightning state_dict (numpy
    values), with the two dead entries zero-filled: the exact inverse of
    convert_state_dict plus what the reference's strict loader expects."""

    def lin(p):
        return {"weight": np.ascontiguousarray(np.asarray(p["w"]).T),
                "bias": np.asarray(p["b"]).copy()}

    def wn(p):
        return {"weight_v": np.ascontiguousarray(np.asarray(p["v"]).T),
                "weight_g": np.asarray(p["g"])[:, None].copy(),
                "bias": np.asarray(p["b"]).copy()}

    sd: dict = {"embedding_a.weight": np.asarray(params["embedding_a"]).copy()}

    def put(prefix, entries):
        for k, v in entries.items():
            sd[f"{prefix}.{k}"] = v

    ncw = params["neuconw"]
    for name, p in ncw["sdf"].items():  # lin{L}
        put(f"neuconw.sdf_net.{name}", wn(p))
    sd["neuconw.xyz_encoding_final.weight"] = np.zeros((512, 512), np.float32)
    sd["neuconw.xyz_encoding_final.bias"] = np.zeros((512,), np.float32)
    sd["neuconw.deviation_network.variance"] = np.asarray(ncw["variance"], np.float32).reshape(())
    for name, p in ncw["color"].items():
        if name.startswith("lin"):
            put(f"neuconw.color_net.{name}", wn(p))
        elif name == "xyz_final":
            put("neuconw.color_net.xyz_encoding_final", lin(p))
        elif name.startswith("static"):
            put(f"neuconw.color_net.static_encoding.static_linear_{name[len('static'):]}", lin(p))
        else:
            raise KeyError(f"unknown color entry {name}")

    bg = params["nerf_bg"]
    for name, p in bg.items():
        if name.startswith("pts"):
            put(f"nerf.pts_linears.{name[3:]}", lin(p))
        elif name in ("alpha", "feature", "rgb"):
            put(f"nerf.{name}_linear", lin(p))
        elif name.startswith("app"):
            put(f"nerf.apperence_encoding.static_linear_{name[3:]}", lin(p))
        elif name == "views0":
            put("nerf.views_linears.0", lin(p))
        else:
            raise KeyError(f"unknown bg entry {name}")
    if "views0" not in bg:  # dead layer in ENCODE_A_BG checkpoints
        w = int(np.asarray(bg["pts0"]["w"]).shape[1])
        half = int(np.asarray(bg["rgb"]["w"]).shape[0])
        sd["nerf.views_linears.0.weight"] = np.zeros((half, bg_dir_dim + w), np.float32)
        sd["nerf.views_linears.0.bias"] = np.zeros((half,), np.float32)
    return sd


# ------------------------------ the port ------------------------------


def params_from_jax(np_params: dict) -> dict:
    """JAX parameter pytree (numpy leaves) -> the port's state_dict."""
    sd = export_state_dict(np_params)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in without_dead_entries(sd, "views0" not in np_params["nerf_bg"]).items()}


def field_from_jax(np_params: dict, fc: FieldConfig, device=None) -> NeuconWField:
    """A NeuconWField holding the JAX parameters, loaded strictly, on
    ``device`` (default: the card)."""
    model = NeuconWField(fc, device)
    model.load_state_dict(params_from_jax(np_params), strict=True)
    return model


def _optax_state(opt_state, fields: tuple):
    """The first optax state inside an opt_state tree of tuples that has
    ``fields`` (a NamedTuple's ``_fields``), or None: ScaleByAdamState
    (count, mu, nu) for Adam and RAdam, TraceState (trace) for SGD's
    momentum, ScaleByScheduleState (count). Found by its fields, so optax
    is not imported here."""
    if all(f in getattr(opt_state, "_fields", ()) for f in fields):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _optax_state(s, fields)
            if found is not None:
                return found
    return None


def state_from_jax(np_state, fc: FieldConfig, optimizer_spec, grid=None, device=None):
    """A JAX ``TrainState`` (params, the optax state and step, numpy leaves)
    and optionally the JAX package's fine ``VoxelGrid`` as the port's:
    (``training.step.TrainState``, ``ops.voxel_grid.VoxelGrid`` or None).
    The model holds the parameters, the ``Optimizer`` the update count its
    schedule reads and, per parameter, the state of the optimiser
    ``optimizer_spec`` names: for Adam and RAdam optax's ScaleByAdamState
    as ``step`` (its count), ``exp_avg`` (mu) and ``exp_avg_sq`` (nu); for
    SGD the TraceState's trace as ``momentum_buffer``, the count that of
    the LR schedule's state, or with a constant LR the step. The grid's
    cells are put in the port's order."""
    from ..ops.voxel_grid import VoxelGrid, _sort_coords
    from ..training.step import TrainState

    model = field_from_jax(np_state.params, fc, device)
    optimizer = optimizer_spec.init(model.parameters())
    named = dict(model.named_parameters())
    if optimizer_spec.name == "sgd":
        trace = _optax_state(np_state.opt_state, ("trace",))
        if trace is None:
            raise ValueError("the JAX opt_state holds no SGD momentum (TraceState)")
        sched = _optax_state(np_state.opt_state, ("count",))
        count = int(np.asarray(sched.count if sched is not None else np_state.step))
        per = {"momentum_buffer": params_from_jax(trace.trace)}
    else:
        adam = _optax_state(np_state.opt_state, ("count", "mu", "nu"))
        if adam is None:
            raise ValueError(f"the JAX opt_state holds no {optimizer_spec.name} state "
                             "(count, mu, nu)")
        count = int(np.asarray(adam.count))
        per = {"exp_avg": params_from_jax(adam.mu), "exp_avg_sq": params_from_jax(adam.nu)}
    for name, p in named.items():
        st = {} if optimizer_spec.name == "sgd" else {"step": torch.tensor(float(count))}
        optimizer.opt.state[p] = {**st, **{k: v[name].to(p.device).reshape(p.shape).clone()
                                           for k, v in per.items()}}
    optimizer.count = count
    fine = None
    if grid is not None:
        fine = VoxelGrid(int(grid.level), np.asarray(grid.origin, np.float64), float(grid.scale),
                         _sort_coords(np.asarray(grid.coords), int(grid.level)))
    return TrainState(model, optimizer, int(np.asarray(np_state.step))), fine


def lpips_from_jax(np_params: dict, net: str = "vgg", device=None):
    """The JAX package's LPIPS pytree (``training/lpips.py``: 'slices' of
    {'w' (O, I, k, k), 'b'} and per-slice 'heads' (C,), numpy leaves) as
    the port's ``training.lpips.LPIPS`` module, loaded strictly, on
    ``device`` (default: the card)."""
    from ..training.lpips import LPIPS

    convs = [c for s in np_params["slices"] for c in s]
    model = LPIPS(net, channels=[np.shape(c["w"])[0] for c in convs], device=device)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    for name, c in zip(model.conv_names(), convs):
        sd[f"{name}.weight"] = torch.from_numpy(np.array(c["w"], np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(c["b"], np.float32))
    for k, head in enumerate(np_params["heads"]):
        w = torch.from_numpy(np.array(head, np.float32)).reshape(1, -1, 1, 1)
        sd[f"lin{k}.model.1.weight"] = sd[f"lins.{k}.model.1.weight"] = w
    model.load_state_dict(sd, strict=True)
    return model
