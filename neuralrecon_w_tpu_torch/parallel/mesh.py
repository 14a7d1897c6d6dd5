"""Data and tensor parallelism over ``torch.distributed``
(``neuralrecon_w_tpu/parallel/mesh.py``; reference train.py:55,
utils/comm.py:22-53).

The JAX package is single-controller: one process drives a (data, model)
device mesh and XLA inserts the gradient psum from sharding annotations.
The port runs one process, a rank, per card: ``n_local`` ranks on each of
``num_processes`` hosts, rank ``process_id * n_local + local_rank``, NCCL
between cards and gloo on the CPU. Its counterparts of the mesh helpers:

  * ``make_mesh`` -> ``init_data_group`` (one rank's membership) and
    ``spawn`` (the ranks of one host);
  * ``data_sharding`` -> ``shard_rays``: a rank's contiguous slice of its
    process's batch, JAX's ``P(DATA_AXIS)`` split; across processes each
    contributes its own batch, as ``make_array_from_process_local_data``;
  * ``replicated`` -> every rank holds the same parameters, kept bit for bit
    equal by the SUM all-reduce of every gradient in ``training/step.py``.

A group may also have a ``model`` axis (``init_data_group(..., n_model=)``,
``make_mesh(n_data, n_model)``): its ``n_data * n_model`` ranks are laid out
as JAX's mesh, rank ``data_rank * n_model + model_rank``. The ranks of one
data shard (``model_pg``) see the same rays and hold the field split by
``field_param_specs`` (``mesh.py:63-96``, JAX's rule in the port's layout);
the ranks that hold one model shard (``data_pg``) reduce its gradient.
``parallel/tensor.py`` splits the field and does its arithmetic. With
``n_model`` 1 the group is the data-parallel group above, bit for bit.
"""

from __future__ import annotations

import datetime
import socket
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class DataGroup:
    """One rank's place in the group of ``n_data`` data shards times
    ``n_model`` model shards (rank = data_rank * n_model + model_rank)."""

    world_size: int
    rank: int
    local_rank: int
    n_local: int  # ranks on this host
    num_processes: int  # hosts
    process_id: int
    device: torch.device
    backend: str
    pg: object  # the process group of every rank
    n_model: int = 1
    data_pg: object = None  # the ranks holding this rank's model shard
    model_pg: object = None  # the ranks of this rank's data shard (None with n_model 1)

    @property
    def n_data(self) -> int:
        return self.world_size // self.n_model

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model


def is_main(group) -> bool:
    """Rank 0, or a run without a group."""
    return group is None or group.rank == 0


def rank_seed(seed: int, index: int) -> int:
    """The seed of rank or shard ``index``'s random stream: ``seed`` itself
    at 0, its own stream at any other. The offset is an odd 32-bit number:
    torch's CPU generator reads only a seed's low 32 bits."""
    return int(seed) + int(index) * 0x9E3779B1


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def split_for_devices(x: np.ndarray, n_devices: int, pad_value=0.0):
    """The leading axis padded to a multiple of n_devices with ``pad_value``
    (``mesh.py:103-113``); returns the padded array and the original length."""
    n = x.shape[0]
    target = pad_to_multiple(max(n, 1), n_devices)
    if target == n:
        return x, n
    pad = np.full((target - n,) + x.shape[1:], pad_value, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0), n


def free_coordinator() -> str:
    """``localhost:<port>`` on a port free now, for the ranks of one host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def init_data_group(n_local: int, num_processes: int = 1, process_id: int = 0,
                    coordinator: str | None = None, backend: str | None = None,
                    device=None, local_rank: int = 0, n_model: int = 1) -> DataGroup:
    """Join the group of ``num_processes * n_local`` ranks as rank
    ``process_id * n_local + local_rank``, rendezvous at
    ``tcp://<coordinator>`` (``host:port``; a free local port when the
    group has one rank). ``device`` defaults to card ``local_rank``; the
    backend to NCCL on a card and gloo on the CPU. gloo on a card is the
    caller's explicit choice (two ranks sharing one card, which NCCL
    refuses): nothing here falls back from one backend to the other.
    ``n_model`` consecutive ranks of one host share a data shard
    (``make_mesh(n_data, n_model)``); every rank makes every sub-group."""
    world = num_processes * n_local
    if not (0 <= local_rank < n_local and 0 <= process_id < num_processes):
        raise ValueError(f"local rank {local_rank} of {n_local}, process {process_id} of "
                         f"{num_processes}")
    if n_model < 1 or n_local % n_model:
        raise ValueError(f"a model axis of {n_model} ranks must divide a host's {n_local}")
    if coordinator is None:
        if world != 1:
            raise ValueError(f"a group of {world} ranks needs a coordinator host:port")
        coordinator = free_coordinator()
    device = torch.device("cuda", local_rank) if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL runs on cards; a CPU rank takes gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = process_id * n_local + local_rank
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=world,
                            rank=rank, timeout=TIMEOUT)
    data_pg, model_pg = dist.group.WORLD, None
    if n_model > 1:
        n_data = world // n_model
        for d in range(n_data):
            pg = dist.new_group([d * n_model + m for m in range(n_model)], timeout=TIMEOUT)
            model_pg = pg if rank // n_model == d else model_pg
        for m in range(n_model):
            pg = dist.new_group([d * n_model + m for d in range(n_data)], timeout=TIMEOUT)
            data_pg = pg if rank % n_model == m else data_pg
    return DataGroup(world, rank, local_rank, n_local, num_processes, process_id, device,
                     backend, dist.group.WORLD, n_model, data_pg, model_pg)


def destroy(group: DataGroup | None) -> None:
    """Leave the group (all ranks call it)."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, n_local: int, args: tuple = ()) -> None:
    """fn(local_rank, *args) in ``n_local`` new processes, started by
    ``spawn`` (a fork cannot use a card its parent has initialised), joined;
    a rank that raises makes this raise. ``fn`` must be importable by
    name: it lives in the port, so a child imports no test module."""
    torch.multiprocessing.start_processes(fn, args=args, nprocs=n_local, join=True,
                                          start_method="spawn")


def run_rank(local_rank: int, fn, args, n_local: int, num_processes: int = 1,
             process_id: int = 0, coordinator: str | None = None, backend: str | None = None,
             device=None):
    """``fn(args, group)`` as rank ``local_rank`` of the group
    ``init_data_group`` makes of the other arguments, leaving the group
    after it; ``spawn``'s target for an entry point's ranks."""
    group = init_data_group(n_local, num_processes, process_id, coordinator, backend, device,
                            local_rank)
    try:
        return fn(args, group)
    finally:
        destroy(group)


def shard_rays(group: DataGroup | None, batch: dict) -> dict:
    """This rank's contiguous slice of its process's batch (every array's
    leading axis split over the host's data shards, ``n_local / n_model``;
    JAX's ``P(DATA_AXIS)``, so the model ranks of a shard get the same
    slice); the batch itself without a group. The batch must divide."""
    if group is None or group.n_local == group.n_model:
        return batch
    n_model = group.n_model
    shards = group.n_local // n_model
    n = len(next(iter(batch.values())))
    if n % shards:
        raise ValueError(f"a batch of {n} rays does not divide over {shards} ranks")
    per = n // shards
    lo = (group.local_rank // n_model) * per
    return {k: v[lo:lo + per] for k, v in batch.items()}


def all_reduce_sum_(group: DataGroup | None, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data ranks (every rank when ``n_model`` is 1),
    in place; every rank gets the same bits."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.data_pg)
    return t


def all_gather_rows(group: DataGroup | None, t: torch.Tensor, n: int | None = None):
    """The data ranks' ``t`` (the same shape on each; every rank's when
    ``n_model`` is 1) concatenated in rank order along the leading axis,
    trimmed to ``n`` rows; on every rank."""
    if group is not None:
        parts = [torch.empty_like(t) for _ in range(group.n_data)]
        dist.all_gather(parts, t.contiguous(), group=group.data_pg)
        t = torch.cat(parts)
    return t if n is None else t[:n]


def field_param_specs(n_model: int, model) -> dict:
    """{state-dict name: "col" | "row" | "vocab" | None}: how each of
    ``model``'s parameters splits over a model axis of ``n_model`` ranks, by
    JAX's rule (``mesh.py:63-96``) in the port's layout. A linear's output
    dim splits (column; torch's (d_out, d_in) weight along dim 0, and
    ``weight_g`` (d_out, 1) and the bias with it, as JAX's 1-D g and b);
    where it does not divide, its input dim (row; the weight along dim 1,
    g and b whole); the appearance table by vocab rows; what divides on
    neither dim stays whole (None), as does everything with ``n_model`` 1."""
    specs = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        spec = None
        if n_model == 1:
            pass
        elif name.startswith("embedding_a."):
            spec = "vocab" if p.shape[0] % n_model == 0 else None
        elif leaf in ("weight_v", "weight") and p.dim() == 2:
            d_out, d_in = p.shape
            spec = "col" if d_out % n_model == 0 else "row" if d_in % n_model == 0 else None
        elif leaf in ("weight_g", "bias") and p.shape[0] % n_model == 0:
            spec = "col"
        specs[name] = spec
    return specs


def barrier(group: DataGroup | None) -> None:
    if group is not None:
        if group.backend == "nccl":
            dist.barrier(group=group.pg, device_ids=[group.device.index])
        else:
            dist.barrier(group=group.pg)


def rank_block(group: DataGroup | None, n: int) -> tuple:
    """(lo, per): rank r's contiguous block [lo, lo + per) of n items in
    equal blocks of per = ceil(n / world) (the last ones short or empty)."""
    w = 1 if group is None else group.world_size
    per = -(-max(n, 1) // w)
    return min((0 if group is None else group.rank) * per, n), per

