"""The training step, the multi-step dispatch and serving's render
functions (``neuralrecon_w_tpu/training/step.py``).

``make_train_step`` is ``step.py:54-111`` in PyTorch: render, the loss
terms, one backward, the clip and the optimiser update, on one batch
(a host ``RayPool`` batch, or a ``DeviceRayPool`` one with its surface-band
cache). The cos-anneal ratio is min(1, step / ANNEAL_END); the semantic
ray mask is a weight, not a ray drop. The sampler's jitter draws from a
``torch.Generator`` seeded from (seed, step); its numbers are not JAX's
``fold_in``.

With a data group (``parallel/mesh.py``) of W ranks, each rank steps on
its slice of the batch: the loss's batch counts are summed over the ranks
before its divisions (one all-reduce of a (5,) vector, ``losses.
batch_counts``), so each rank's loss is its numerator over the global
batch's count; after the backward one SUM all-reduce of a flat buffer of
every gradient (and the aux terms' parts) gives every rank the global
batch's gradient, bit for bit the same, and the clip and the update follow.
That is JAX's step over a data mesh (``step.py:114-146``), whose loss is the
global batch's; DistributedDataParallel's average of per-rank means is not.

A group with a model axis (``n_model`` > 1) trains a field split by
``parallel.tensor.shard_field``: JAX's step with ``param_specs``
(``step.py:114-166``). The model ranks of a data shard take the same slice
and the same jitter (the generator is seeded by the data rank) and compute
the same loss; the collectives of ``parallel/tensor.py`` give each its
blocks' gradients. The whole parameters' gradients are then made the first
model rank's (``sync_replicated_grads``), the counts and the gradients are
summed over the data ranks only, and the clip sums the split blocks'
squares over the model ranks. Each rank's optimiser holds its blocks.

``make_scan_train_fn`` is ``step.py:169-229``: n_inner steps over
consecutive windows of a device pool's epoch permutation. On the CPU it is
a plain loop of the step. On the card it captures one step in a
``torch.cuda.CUDAGraph`` and replays it, in every SDF_GRAD_MODE and with
either background: the batch is gathered inside the graph by a device
cursor, and the step counter (the cos-anneal ratio), the update count (the
LR) and the optimiser's state (Adam's, SGD's or RAdam's: ``schedule.py``)
are device tensors the graph advances. The kernel modes' wrappers pack the
weights from the live parameters inside the captured step, so every
replay reads the weights the update left in place.
Inside the graph the sampler's jitter draws from one generator registered
with the graph, seeded once from (seed, step at capture), so its stream
differs from the eager steps' per-(seed, step) generators. K5 sums with
float atomics, so in the modes that run it a replayed step equals an
eager one only to rounding.

``make_render_fn`` renders one chunk; ``make_scan_render_fn``
(``step.py:239-281``) a whole frame of chunks, on the card as replays of
one chunk captured in a ``torch.cuda.CUDAGraph`` (``ScanRender``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..config import FieldConfig, RenderConfig
from ..models.neuconw import NeuconWField
from ..rendering.renderer import render_rays
from ..parallel.mesh import all_reduce_sum_, rank_seed
from ..parallel.tensor import is_split, sync_replicated_grads
from ..tools.convert import init_field
from ..tracing import prepare, span
from .losses import LossConfig, batch_counts, loss_terms
from .schedule import Optimizer


@dataclass
class TrainState:
    model: NeuconWField
    optimizer: Optimizer
    step: int = 0


def init_state(fc: FieldConfig, optimizer_spec, generator: torch.Generator,
               device=None) -> TrainState:
    """A fresh field and its optimiser state, on ``device`` (default: the card)."""
    model = init_field(fc, generator, device)
    return TrainState(model, optimizer_spec.init(model.parameters()), 0)


def ray_mask_from_labels(labels: torch.Tensor, ray_mask_ids, dtype=torch.float32):
    """1 for supervised rays, 0 for transient classes (``step.py:44-51``)."""
    mask = torch.ones(labels.shape, dtype=dtype, device=labels.device)
    for mid in ray_mask_ids or ():
        mask = torch.where(labels == mid, torch.zeros_like(mask), mask)
    return mask


def step_generator(seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The sampler's generator for one step: seeded from (seed, step) and,
    past rank 0, the data-parallel rank."""
    return torch.Generator(device=device).manual_seed(
        rank_seed(int(seed) * 1_000_003 + int(step), rank))


# a data-parallel step's aux parts that sum to the global batch's psnr
_SQ, _MASKED = "_sq_err", "_masked"


def all_reduce_grads(group, params, aux: dict) -> dict:
    """One SUM all-reduce over the data ranks of every gradient and the aux
    scalars, coalesced in one flat float32 buffer; the gradients are written
    back in place.
    Returns the summed aux. Every rank holds the same parameters with
    gradients or without (that depends on the configuration alone)."""
    grads = [p.grad for p in params if p.grad is not None]
    keys = list(aux)
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [torch.stack([aux[k].detach().float() for k in keys])])
    all_reduce_sum_(group, flat)
    o = 0
    for g in grads:
        g.copy_(flat[o:o + g.numel()].view_as(g))
        o += g.numel()
    return dict(zip(keys, flat[o:]))


def finish_aux(aux: dict) -> dict:
    """The step's aux, detached, with psnr made of its summed parts
    (``metrics.psnr``'s formula)."""
    aux = {k: v.detach() for k, v in aux.items()}
    sq, masked = aux.pop(_SQ), aux.pop(_MASKED)
    aux["psnr"] = -10.0 * torch.log10(torch.clamp(sq / (masked * 3 + 1e-8), min=1e-10))
    return aux


def make_train_step(fc: FieldConfig, rcfg: RenderConfig, lcfg: LossConfig,
                    anneal_end: int, ray_mask_ids: tuple = (), seed: int = 0, group=None):
    """step_fn(state, scene, batch, fine_grid=None, sfm_grid=None) ->
    (state, aux), updating state in place. batch = {"rays": (R, >= 8),
    "ts": (R,), "labels": (R,), "rgbs": (R, 3)}, numpy or tensors, and
    with a fine grid optionally the pool's band cache "surf_t" / "surf_hit"
    (``step.py:73-80``); aux holds psnr, s_val and every loss term as
    detached scalar tensors. With a data ``group`` the batch is this rank's
    slice and aux is the global batch's; with a model axis the field is
    ``shard_field``'s (split before the optimiser was made). ``step_fn.loss_fn`` is the render
    and loss alone, which the captured step reuses (without a group, where
    the count all-reduce is the identity); its aux holds psnr's two parts,
    which ``finish_aux`` makes psnr of."""

    def loss_fn(model, scene, batch, rng, cos_anneal, fine_grid, sfm_grid, group=None):
        ray_mask = ray_mask_from_labels(batch["labels"], ray_mask_ids)
        surf_cache = None
        if fine_grid is not None and "surf_t" in batch:
            surf_cache = (batch["surf_t"], batch["surf_hit"])
        results = render_rays(model, fc, rcfg, scene, batch["rays"], batch["ts"],
                              batch["labels"], rng, cos_anneal, fine_grid=fine_grid,
                              sfm_grid=sfm_grid, ray_mask=ray_mask, surf_cache=surf_cache)
        counts = all_reduce_sum_(group, batch_counts(results))
        terms = loss_terms(lcfg, results, batch["rgbs"], counts)
        # this rank's parts of the global aux: each sums over the ranks
        mask = results["ray_mask"][:, None]
        aux = {"s_val": torch.mean(results["s_val"]) * (mask.shape[0] / counts[4]), **terms,
               _SQ: torch.sum((results["color"] - batch["rgbs"]) ** 2 * mask),
               _MASKED: torch.sum(mask)}
        return terms["loss"], aux

    def step_fn(state: TrainState, scene, batch: dict, fine_grid=None,
                sfm_grid=None):
        dev = scene.origin.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        cos_anneal = min(1.0, state.step / anneal_end) if anneal_end > 0 else 1.0
        rng = step_generator(seed, state.step, dev, 0 if group is None else group.data_rank)
        state.model.train()
        state.optimizer.zero_grad()
        with span("train.render_loss", dev):
            loss, aux = loss_fn(state.model, scene, batch, rng, cos_anneal, fine_grid, sfm_grid,
                                group)
        with span("train.backward", dev):
            loss.backward()
        if group is not None and group.n_model > 1:
            sync_replicated_grads(group, state.model.parameters())
        if group is not None:
            aux = all_reduce_grads(group, state.model.parameters(), aux)
        with span("train.optimizer", dev):
            state.optimizer.step()
        state.step += 1
        return state, finish_aux(aux)

    step_fn.loss_fn = loss_fn
    step_fn.anneal_end = anneal_end
    step_fn.seed = seed
    return step_fn


# eager steps before a capture (the whole-network capture recipe's
# warm-up: lazy state such as the optimiser's moments and the autograd
# engine's is made outside the graph); they are real steps of the window
GRAPH_WARMUP = 2


def make_scan_train_fn(fc: FieldConfig, rcfg: RenderConfig, lcfg: LossConfig,
                       anneal_end: int, ray_mask_ids: tuple, batch_size: int, n_inner: int,
                       seed: int = 0, graph: Optional[bool] = None):
    """n_inner steps per dispatch over a device pool (``step.py:169-229``).

    Returns run(state, scene, pool_data, fine_grid=None, sfm_grid=None,
    perm=None, start=None) -> (state, aux of the last step). With (perm,
    start) from ``DeviceRayPool.take_scan_window``, step i trains on the
    rows perm[start + i * batch_size : ... + batch_size]; with perm None, a
    with-replacement draw. ``graph`` (default: on CUDA tensors) replays a
    captured step (``ScanRun``); False runs the plain loop of the step."""
    step_fn = make_train_step(fc, rcfg, lcfg, anneal_end, ray_mask_ids, seed)
    return ScanRun(step_fn, batch_size, n_inner, graph)


class ScanRun:
    """``make_scan_train_fn``'s run. The graph path captures on its first
    call and keeps, as the graph's inputs, the tensors of that call: the
    pool's arrays and permutation (``DeviceRayPool`` writes both in place),
    the fine grid's words and origin (the caller copies a refreshed grid
    into them; any other tensor there is copied in before the replays), the
    scene. A capture that fails raises. ``captures``, ``replays`` and
    ``per_step_launches`` (the kernel launches one captured step records)
    say what ran: the wrappers' counters tick at capture only. The step's
    device spans (``train.render_loss``, ``train.backward``,
    ``train.optimizer``, ``tracing.py``) are captured with it, so every
    replay stamps them; ``train.inputs`` times a call's hand-off."""

    def __init__(self, step_fn, batch_size: int, n_inner: int, graph: Optional[bool]):
        self.step_fn = step_fn
        self.batch_size, self.n_inner, self.graph = batch_size, n_inner, graph
        self.captures = self.replays = 0
        self.per_step_launches: dict = {}
        self._g = None
        self._data_gen = None

    def __call__(self, state: TrainState, scene, pool_data: dict, fine_grid=None, sfm_grid=None,
                 perm=None, start=None):
        if is_split(state.model):
            # a gloo collective cannot be captured; JAX's scan takes one
            # data shard and no model axis either (step.py:184-185)
            raise ValueError("the multi-step dispatch takes a whole field, not one split over "
                             "a model axis")
        if self.captures_on(pool_data["rays"].device):
            return self._replay(state, scene, pool_data, fine_grid, sfm_grid, perm, start)
        return self._loop(state, scene, pool_data, fine_grid, sfm_grid, perm, start)

    def captures_on(self, device) -> bool:
        """Whether a call on ``device`` replays a graph: ``graph`` if given,
        else the device decides (the card captures, the CPU loops)."""
        return torch.device(device).type == "cuda" if self.graph is None else self.graph

    def _data_generator(self, dev) -> torch.Generator:
        """The with-replacement draw's generator (``perm`` None)."""
        if self._data_gen is None:
            self._data_gen = torch.Generator(device=dev).manual_seed(self.step_fn.seed + 1)
        return self._data_gen

    def _draw(self, n_rows: int, dev):
        return torch.randint(0, n_rows, (self.batch_size,), generator=self._data_generator(dev),
                             device=dev)

    def _loop(self, state, scene, pool_data, fine_grid, sfm_grid, perm, start):
        bs, n_rows = self.batch_size, pool_data["rays"].shape[0]
        aux = None
        for i in range(self.n_inner):
            if perm is None:
                idx = self._draw(n_rows, pool_data["rays"].device)
            else:
                idx = perm[int(start) + i * bs:int(start) + (i + 1) * bs]
            batch = {k: v.index_select(0, idx) for k, v in pool_data.items()}
            state, aux = self.step_fn(state, scene, batch, fine_grid, sfm_grid)
        return state, aux

    # ------------------------------ graph ------------------------------

    def _body(self):
        """One step on the graph's inputs, device state only."""
        st, bs = self._static, self.batch_size
        data, dev = st["data"], st["data"]["rays"].device
        if st["perm"] is None:
            idx = self._draw(data["rays"].shape[0], dev)
        else:
            idx = st["perm"].index_select(0, self._cursor + self._arange)
        self._cursor += bs
        batch = {k: v.index_select(0, idx) for k, v in data.items()}
        anneal_end = self.step_fn.anneal_end
        cos = (torch.clamp(self._step_t / anneal_end, max=1.0).float() if anneal_end > 0
               else 1.0)
        model, opt = st["state"].model, st["state"].optimizer
        model.train()
        with span("train.render_loss", dev):
            loss, aux = self.step_fn.loss_fn(model, st["scene"], batch, self._gen, cos,
                                             st["fine_grid"], st["sfm_grid"])
        with span("train.backward", dev):
            loss.backward()
        with span("train.optimizer", dev):
            opt.graph_step(self._count_t)
        self._step_t += 1
        return finish_aux(aux)

    def _capture(self, state, scene, pool_data, fine_grid, sfm_grid, perm):
        dev = pool_data["rays"].device
        prepare(dev)
        state.optimizer.make_capturable()
        self._static = {"state": state, "scene": scene, "data": dict(pool_data),
                        "fine_grid": fine_grid, "sfm_grid": sfm_grid, "perm": perm}
        self._arange = torch.arange(self.batch_size, device=dev)
        self._cursor = torch.zeros((), dtype=torch.int64, device=dev)
        self._step_t = torch.zeros((), dtype=torch.float64, device=dev)
        self._count_t = torch.zeros((), dtype=torch.float64, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(
            int(self.step_fn.seed) * 1_000_003 + int(state.step))
        if perm is None:
            self._data_generator(dev)

    def _inputs_in(self, state, scene, pool_data, fine_grid, sfm_grid, perm):
        """Hand this call's tensors to the graph: the same tensors as at
        capture, or copies into them."""
        st = self._static
        if state.model is not st["state"].model or scene is not st["scene"] \
                or (perm is None) != (st["perm"] is None) \
                or set(pool_data) != set(st["data"]) \
                or (fine_grid is None) != (st["fine_grid"] is None) or sfm_grid is not st["sfm_grid"]:
            raise ValueError("a captured step takes the state, scene, pool keys and grids it "
                             "was captured with; make a new run for others")
        pairs = [(pool_data[k], st["data"][k]) for k in pool_data]
        if perm is not None:
            pairs.append((perm, st["perm"]))
        if fine_grid is not None:
            fg = st["fine_grid"]
            if (fine_grid.scale, fine_grid.voxel_size) != (fg.scale, fg.voxel_size):
                raise ValueError("a captured step's fine grid keeps its cube and level")
            pairs += [(fine_grid.occ, fg.occ), (fine_grid.origin, fg.origin)]
        for new, old in pairs:
            if new.data_ptr() != old.data_ptr():
                if new.shape != old.shape or new.dtype != old.dtype:
                    raise ValueError("a captured step's inputs keep their shapes")
                old.copy_(new)

    def _replay(self, state, scene, pool_data, fine_grid, sfm_grid, perm, start):
        from ..ops import read_launches

        first = self._g is None
        if first:
            self._capture(state, scene, pool_data, fine_grid, sfm_grid, perm)
        with span("train.inputs"):
            if not first:
                self._inputs_in(state, scene, pool_data, fine_grid, sfm_grid, perm)
            self._cursor.fill_(0 if start is None else int(start))
            self._step_t.fill_(float(state.step))
            self._count_t.fill_(float(state.optimizer.count))
        n_replay, aux = self.n_inner, None
        if first:
            warm = min(GRAPH_WARMUP, self.n_inner)
            side = torch.cuda.Stream(device=self._cursor.device)
            side.wait_stream(torch.cuda.current_stream(self._cursor.device))
            with torch.cuda.stream(side):
                for _ in range(warm):
                    state.optimizer.zero_grad()
                    aux = self._body()
            torch.cuda.current_stream(self._cursor.device).wait_stream(side)
            state.optimizer.zero_grad()
            g = torch.cuda.CUDAGraph()
            if not hasattr(g, "register_generator_state"):
                raise RuntimeError("this torch's CUDAGraph cannot register a generator")
            g.register_generator_state(self._gen)
            if self._data_gen is not None:
                g.register_generator_state(self._data_gen)
            before = read_launches()
            # entering the capture synchronises and empties the allocator's
            # cache: the warm-up's blocks go back to the card before the
            # graph's private pool fills, so 'fwd' at batch 8192 (~40 GiB a
            # step) holds one step's memory, not two
            with torch.cuda.graph(g):
                self._aux = self._body()
            after = read_launches()
            self.per_step_launches = {k: after[k] - before[k] for k in after if after[k] - before[k]}
            self._g = g
            self.captures += 1
            n_replay -= warm
        for _ in range(n_replay):
            self._g.replay()
        self.replays += n_replay
        if n_replay:
            aux = {k: v.clone() for k, v in self._aux.items()}
        state.step += self.n_inner
        state.optimizer.count += self.n_inner
        return state, aux

    def release(self) -> None:
        """Drop the graph and its memory pool."""
        self._g = self._aux = None
        self._static = {}


def make_render_fn(fc: FieldConfig, rcfg: RenderConfig):
    """Deterministic chunk render for image synthesis: perturb 0,
    cos_anneal_ratio 1, no ray mask, no autograd graph kept."""

    def render_chunk(model, scene, rays, ts, labels, rng=None, fine_grid=None, sfm_grid=None):
        with torch.no_grad():
            return render_rays(model, fc, rcfg, scene, rays, ts, labels, rng,
                               cos_anneal_ratio=1.0, fine_grid=fine_grid,
                               sfm_grid=sfm_grid, perturb_overwrite=0.0)

    return render_chunk


def make_scan_render_fn(fc: FieldConfig, rcfg: RenderConfig, chunk: int):
    """Whole-frame render over chunk-sized ray tiles (``step.py:239-281``):
    run(model, scene, rays, ts, labels, rng=None, fine_grid=None,
    sfm_grid=None) -> {"color" (N, 3), "depth" (N,), "normal" (N, 3)} on the
    rays' device, N a multiple of ``chunk`` (the caller pads). Only the
    images ``render_image`` takes leave a chunk: the weighted normal is
    reduced inside it, so no (rays, samples) tensor outlives one. Perturb 0,
    cos_anneal 1, no autograd graph kept, so ``rng`` goes unused (JAX's
    signature). CUDA tensors replay a captured chunk (``ScanRender``); CPU
    tensors run the plain loop of the same chunk."""
    return ScanRender(fc, rcfg, chunk)


class ScanRender:
    """``make_scan_render_fn``'s run. On the card the first call renders one
    chunk eagerly (lazy state: the kernel library, the background's index
    tensors, cuBLAS's workspace), then captures one chunk's render from
    static input buffers into static outputs; every chunk of every frame
    is then copied into the inputs on the device, replayed, and its outputs
    copied into the frame's on the device (``render_image`` fetches the
    frame once). The graph
    holds the model, the scene and the grids it was captured with: a new
    fine or SFM grid of the same level is copied into the captured tensors,
    and a call with another model or grid layout raises. A capture that
    fails raises. ``captures``, ``replays`` and ``per_chunk_launches`` (the
    kernel launches one captured chunk records) say what ran: the
    wrappers' counters tick at capture only. Serves every SDF_GRAD_MODE
    with either background: the forward kernels (K3, K6, K8) have no
    atomics, so a replayed chunk equals an eager one bit for bit."""

    def __init__(self, fc: FieldConfig, rcfg: RenderConfig, chunk: int):
        self.fc, self.rcfg, self.chunk = fc, rcfg, int(chunk)
        self.captures = self.replays = 0
        self.per_chunk_launches: dict = {}
        self._g = None
        self._static: dict = {}

    def body(self, model, scene, rays, ts, labels, fine_grid=None, sfm_grid=None):
        """One chunk: (color (R, 3), depth (R,), weighted normal (R, 3))."""
        out = render_rays(model, self.fc, self.rcfg, scene, rays, ts, labels, None,
                          cos_anneal_ratio=1.0, fine_grid=fine_grid, sfm_grid=sfm_grid,
                          perturb_overwrite=0.0)
        g = out["gradients"]
        return out["color"], out["depth"], (g * out["weights"][:, :g.shape[1], None]).sum(dim=1)

    def __call__(self, model, scene, rays, ts, labels, rng=None, fine_grid=None, sfm_grid=None):
        n = rays.shape[0]
        if n % self.chunk or ts.shape[0] != n or labels.shape[0] != n:
            raise ValueError(f"scan render: {n} rays, ts and labels in chunks of {self.chunk} "
                             "(pad the frame first)")
        with torch.no_grad():
            if rays.device.type == "cuda":
                if is_split(model):
                    raise ValueError("a captured frame takes a whole field, not one split over "
                                     "a model axis (a gloo collective cannot be captured)")
                return self._replay(model, scene, rays, ts, labels, fine_grid, sfm_grid)
            outs = [self.body(model, scene, rays[i:i + self.chunk], ts[i:i + self.chunk],
                              labels[i:i + self.chunk], fine_grid, sfm_grid)
                    for i in range(0, n, self.chunk)]
        return {k: torch.cat([o[j] for o in outs]) for j, k in
                enumerate(("color", "depth", "normal"))}

    # ------------------------------ graph ------------------------------

    def _capture(self, model, scene, rays, ts, labels, fine_grid, sfm_grid):
        from ..ops import read_launches

        c, dev = self.chunk, rays.device
        prepare(dev)
        st = {"model": model, "scene": scene, "fine_grid": fine_grid, "sfm_grid": sfm_grid,
              "rays": rays[:c].clone(), "ts": ts[:c].clone(), "labels": labels[:c].clone()}
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.body(model, scene, st["rays"], st["ts"], st["labels"], fine_grid, sfm_grid)
        torch.cuda.current_stream(dev).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        before = read_launches()
        with torch.cuda.graph(g):
            st["out"] = self.body(model, scene, st["rays"], st["ts"], st["labels"], fine_grid,
                                  sfm_grid)
        after = read_launches()
        self.per_chunk_launches = {k: after[k] - before[k] for k in after
                                   if after[k] - before[k]}
        self._g, self._static = g, st
        self.captures += 1

    def _inputs_in(self, model, scene, rays, ts, labels, fine_grid, sfm_grid):
        """Hand this call's model, scene and grids to the graph: the captured
        tensors, or copies into them."""
        st = self._static
        if model is not st["model"] or (fine_grid is None) != (st["fine_grid"] is None) \
                or (sfm_grid is None) != (st["sfm_grid"] is None) \
                or rays.shape[1:] != st["rays"].shape[1:] or rays.dtype != st["rays"].dtype \
                or ts.dtype != st["ts"].dtype or labels.dtype != st["labels"].dtype:
            raise ValueError("a captured frame takes the model, grids and ray layout it was "
                             "captured with; make a new scan render for others")
        pairs = list(zip(scene, st["scene"]))
        for new, old in ((fine_grid, st["fine_grid"]), (sfm_grid, st["sfm_grid"])):
            if new is None:
                continue
            if type(new) is not type(old) or (new.scale, new.voxel_size) != (old.scale,
                                                                            old.voxel_size):
                raise ValueError("a captured frame's grids keep their layout, cube and level")
            pairs += [(a, b) for a, b in zip(new, old) if isinstance(a, torch.Tensor)]
        for new, old in pairs:
            if new.data_ptr() != old.data_ptr():
                if new.shape != old.shape or new.dtype != old.dtype:
                    raise ValueError("a captured frame's scene and grids keep their shapes")
                old.copy_(new)

    def _replay(self, model, scene, rays, ts, labels, fine_grid, sfm_grid):
        if self._g is None:
            self._capture(model, scene, rays, ts, labels, fine_grid, sfm_grid)
        else:
            self._inputs_in(model, scene, rays, ts, labels, fine_grid, sfm_grid)
        st, c, n = self._static, self.chunk, rays.shape[0]
        frame = [torch.empty((n,) + o.shape[1:], dtype=o.dtype, device=o.device)
                 for o in st["out"]]
        for i in range(0, n, c):
            st["rays"].copy_(rays[i:i + c])
            st["ts"].copy_(ts[i:i + c])
            st["labels"].copy_(labels[i:i + c])
            self._g.replay()
            for dst, src in zip(frame, st["out"]):
                dst[i:i + c].copy_(src)
        self.replays += n // c
        return dict(zip(("color", "depth", "normal"), frame))

    def release(self) -> None:
        """Drop the graph and its memory pool."""
        self._g = None
        self._static = {}
