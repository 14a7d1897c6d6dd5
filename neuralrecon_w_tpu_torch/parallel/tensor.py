"""Tensor parallelism over the ``model`` axis: the field's parameters split
across the model ranks of a group (``parallel/mesh.py``), in Megatron's
form over ``torch.distributed``.

The JAX package splits the field by annotation (``field_param_specs`` into
``jit_train_step(param_specs=)``, ``neuralrecon_w_tpu/training/step.py:
114-166``) and XLA inserts the collectives. Here they are written out:

  * ``shard_field`` keeps each split parameter's block on this rank, by
    ``field_param_specs``'s rule, and marks the parameter with its ``Split``
    (an attribute ``tp``, as Megatron marks its parameters); the optimiser
    made after it holds the blocks, so Adam's moments follow the split;
  * the four collectives below, which ``models/layers.py`` composes into
    a split linear (``tp_linear``) and into a split layer's whole weight
    (``layer_weight``) for the kernels and for 'fwd' (no collective runs
    inside ``torch.func``'s transforms);
  * ``vocab_lookup``: the appearance table split by rows, each rank's rows
    looked up (zeros for ids outside them) and summed over the ranks.

Every model rank computes the same loss, so a tensor that every rank holds
alike carries the whole gradient on each. The four collectives are
Megatron's conjugate pairs: ``copy`` (identity; backward all-reduce) and
``reduce`` (all-reduce; backward identity), ``gather`` (the blocks
concatenated; backward this rank's block) and ``split`` (this rank's block;
backward the blocks concatenated). Each backward is its conjugate's
``apply``, so a backward with ``create_graph=True`` is itself
differentiable: the eikonal loss differentiates d sdf / d x once more.
They are made of ``all_reduce`` and ``all_gather`` alone, which gloo runs
on card tensors (two ranks on one card, which NCCL refuses); values
narrower than float32 travel as float32. ``torch.distributed.nn``'s
``all_reduce`` is not ``reduce``: its backward all-reduces again, which
multiplies every gradient upstream of it by the number of model ranks.
"""

from __future__ import annotations

import copy as _copy
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .mesh import field_param_specs


@dataclass(frozen=True, eq=False)
class Axis:
    """A rank's model axis: ``n`` ranks, this one ``rank``, over ``pg``."""

    n: int
    rank: int
    pg: object


@dataclass(frozen=True, eq=False)
class Split:
    """How a parameter is split: ``kind`` as ``field_param_specs`` names it
    ("col", "row" or "vocab"), along ``dim``, over ``axis``."""

    kind: str
    dim: int
    axis: Axis


def model_axis(group) -> Axis:
    return Axis(group.n_model, group.model_rank, group.model_pg)


# ------------------------------ collectives ------------------------------


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` to send, in float32 or wider."""
    wide = x.dtype in (torch.float32, torch.float64)
    return (x if wide else x.float()).clone(memory_format=torch.contiguous_format)


def all_reduce_raw(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """x summed over the axis (a new tensor); every rank gets the same bits."""
    out = _wire(x)
    dist.all_reduce(out, group=axis.pg)
    _count(all_reduce_raw, out)
    return out.to(x.dtype)


def all_gather_raw(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(axis.n)]
    dist.all_gather(parts, w, group=axis.pg)
    out = torch.cat(parts, dim)
    _count(all_gather_raw, out)
    return out.to(x.dtype)


def _count(fn, out: torch.Tensor) -> None:
    fn.calls += 1
    fn.bytes += out.numel() * out.element_size()


def traffic(reset: bool = False) -> dict:
    """The model axis's collectives in this process since the last reset:
    calls and bytes (each result's size on the wire: the summed tensor of
    an all-reduce, the whole of a gather) of each kind."""
    fns = {"all_reduce": all_reduce_raw, "all_gather": all_gather_raw}
    got = {k: {"calls": f.calls, "bytes": f.bytes} for k, f in fns.items()}
    if reset:
        for f in fns.values():
            f.calls = f.bytes = 0
    return got


all_reduce_raw.calls = all_reduce_raw.bytes = 0
all_gather_raw.calls = all_gather_raw.bytes = 0


def block(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (a copy); the dim divides."""
    k = x.shape[dim] // axis.n
    if k * axis.n != x.shape[dim]:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {axis.n} ranks")
    return x.narrow(dim, axis.rank * k, k).clone()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_raw(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.axis), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather_raw(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _Split.apply(g, ctx.axis, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return block(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.axis, ctx.dim), None, None


def copy(x, axis: Axis):
    """Identity; the gradient summed over the ranks."""
    return _Copy.apply(x, axis)


def reduce(x, axis: Axis):
    """x summed over the ranks; the gradient passed through."""
    return _Reduce.apply(x, axis)


def gather(x, axis: Axis, dim: int = -1):
    """The ranks' blocks concatenated along ``dim``; the gradient's block."""
    return _Gather.apply(x, axis, dim)


def split(x, axis: Axis, dim: int = -1):
    """This rank's block along ``dim``; the blocks' gradients concatenated."""
    return _Split.apply(x, axis, dim)


# --------------------------- split parameters ---------------------------


def split_of(layer) -> Split | None:
    """A linear's split (its weight's ``tp`` mark), or None when whole."""
    w = layer.weight_v if hasattr(layer, "weight_v") else layer.weight
    return getattr(w, "tp", None)


def is_split(model) -> bool:
    """Whether a parameter of ``model`` is split over a model axis."""
    return any(getattr(p, "tp", None) is not None for p in model.parameters())


@torch.no_grad()
def shard_field(model, group):
    """Split ``model``'s parameters in place over ``group``'s model axis by
    ``field_param_specs``: a split parameter keeps this rank's block and is
    marked with its ``Split``; the rest stay whole on every rank. Make the
    optimiser after this. Returns ``model``."""
    axis = model_axis(group)
    for name, kind in field_param_specs(group.n_model, model).items():
        if kind is None:
            continue
        p = model.get_parameter(name)
        dim = 1 if kind == "row" else 0
        p.data = block(p.data, axis, dim)
        p.tp = Split(kind, dim, axis)
    return model


@torch.no_grad()
def gather_field(model):
    """A whole copy of a split ``model`` on every rank (the reference's
    state-dict names and shapes, no parameter marked); ``model`` stays
    split."""
    whole = _copy.deepcopy(model)
    for p, q in zip(model.parameters(), whole.parameters()):
        q.__dict__.pop("tp", None)
        s = getattr(p, "tp", None)
        if s is not None:
            q.data = all_gather_raw(p.data, s.axis, s.dim)
    return whole


def sync_replicated_grads(group, params) -> None:
    """The gradients of the parameters every model rank holds whole, made
    the model ranks' first one's, bit for bit, in one broadcast (a kernel's
    float atomics may round them differently on each rank)."""
    grads = [p.grad for p in params if p.grad is not None and getattr(p, "tp", None) is None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.broadcast(flat, src=group.data_rank * group.n_model, group=group.model_pg)
    o = 0
    for g in grads:
        g.copy_(flat[o:o + g.numel()].view_as(g))
        o += g.numel()


# ------------------------------ arithmetic ------------------------------


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for a table split by rows over the model axis: each rank
    looks up its rows (zeros elsewhere) and the ranks' rows are summed. The
    lookup is indexing, whose backward is a sorted (deterministic)
    index_put. A whole table is indexed as it is."""
    s = getattr(table, "tp", None)
    if s is None:
        return table[ids]
    rows = table.shape[0]
    local = ids - s.axis.rank * rows
    hit = (local >= 0) & (local < rows)
    got = table[torch.where(hit, local, torch.zeros_like(local))]
    return reduce(torch.where(hit[:, None], got, torch.zeros_like(got)), s.axis)
