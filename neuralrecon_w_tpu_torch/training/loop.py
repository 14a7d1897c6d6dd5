"""Training orchestration for one scene on one card
(``neuralrecon_w_tpu/training/loop.py``; reference train.py:16-71,
lightning_modules/neuconw_system.py:60-546).

One Python loop drives: batches -> the train step -> the surface refresh
every UPDATE_FREQ steps -> checkpoints every SAVE_FREQ steps -> validation
every VAL_FREQ (a fraction of an epoch, or a step count). The loop reads
nothing back from the card between log points: scalars come to the host
every ``log_every`` steps and at the end.

``TPU.DEVICE_POOL`` (``resolve_device_pool``): 'auto' keeps the rays on the
card when the Trainer runs on one (``datasets/cache.DeviceRayPool``), as
the JAX package's 'auto' follows its accelerator, and in host memory on
the CPU (a batch then goes to the device as one non-blocking copy from
pinned memory); true / false force either. With the device pool the
surface-band cache is re-attached after every refresh that keeps cells,
and ``TPU.SCAN_INNER`` steps (capped to an epoch's batches, off below 2)
run as one dispatch (``step.make_scan_train_fn``) wherever no refresh,
save, validation or the end falls inside them: on the card one captured
CUDA graph replayed, in every SDF_GRAD_MODE and with either background;
on the CPU the plain loop of the step. ``TrainerConfig.profile_start`` /
``profile_steps`` open a ``torch.profiler`` window over those steps (in
place of the JAX package's ``jax.profiler`` trace, ``loop.py:292-297``)
and write its Chrome trace under ``<exp_dir>/profile``.

With a data group (``parallel/mesh.py``; ``loop.py:103-107, 143-145,
181-184, 262-279, 413-427``) every rank runs this loop in lockstep on its
own card: ``batch_size`` is the process's batch, split over its
``n_local`` ranks (it must divide); a process of a multi-process group
reads its own share of the cache splits; the device pool is sharded over
the host's ranks and the multi-step dispatch is off (a captured step takes
no collective); the step all-reduces (``training/step.py``); the refresh,
the validation render and the inline mesh sweep are split over the ranks
(the render only when the group lies on one host and ``test_batch_size``
divides over it; else every rank renders the whole image). Rank 0 alone
writes checkpoints, logs, validation images and profiles; every rank checks
at each save that the ranks' parameters are bit for bit equal, then waits
at a barrier.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
import types
from dataclasses import dataclass

import numpy as np
import torch

from ..config import field_config_from_cfg, render_config_from_cfg
from ..datasets.cache import DeviceRayPool, RayPool, local_split_names, read_ray_cache
from ..datasets.mask_utils import get_label_id_mapping
from ..device import default_device
from ..ops.ray_voxel import device_grid_from_host
from ..ops.voxel_grid import VoxelGrid
from ..parallel.mesh import all_gather_rows, barrier, is_main, shard_rays
from ..tools.convert import without_dead_entries
from ..tracing import span_ms
from .checkpoint import restore_checkpoint, save_checkpoint
from .losses import loss_config_from_cfg
from .schedule import make_optimizer
from .step import init_state, make_render_fn, make_scan_train_fn, make_train_step
from .surface import octree_update, surface_level


def resolve_device_pool(option, device) -> bool:
    """TPU.DEVICE_POOL: 'auto' is the device pool on a CUDA device and the
    host pool elsewhere (``loop.py:246-260``: JAX's 'auto' is the device
    pool on its accelerator); true / false force it."""
    if isinstance(option, str):
        low = option.lower()
        if low == "auto":
            return torch.device(device).type == "cuda"
        if low not in ("true", "false"):
            raise ValueError(f"TPU.DEVICE_POOL {option!r}: 'auto', true or false")
        return low == "true"
    return bool(option)


def val_interval(val_freq: float, steps_per_epoch: int) -> int:
    """Steps between validations, Lightning's val_check_interval's two
    meanings (reference train.py:57): at most 1.0 a fraction of an epoch,
    above 1 a step count."""
    if val_freq > 1.0:
        return int(val_freq)
    return max(int(steps_per_epoch * val_freq), 1)


def _summary_writer(log_dir: str):
    """torch's SummaryWriter on ``log_dir``, or None without the tensorboard
    package. Unless the process has loaded TensorFlow already, tensorboard
    is held to its TF-free stub (the marker module of its no-TensorFlow
    build, ``tensorboard.compat.notf``): left to itself it imports
    TensorFlow, which can import JAX, and the port imports neither."""
    if "tensorflow" not in sys.modules:
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class MetricsLogger:
    """Scalars as JSON lines in ``<log_dir>/metrics.jsonl`` (in place of
    the reference's TestTubeLogger, train.py:38-42), mirrored to a
    TensorBoard event file in ``log_dir`` where
    ``torch.utils.tensorboard`` imports (``loop.py:50-68``)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = _summary_writer(log_dir)

    def log(self, step: int, scalars: dict):
        rec = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """The logger of every rank but 0, which logs nowhere (``loop.py:71-78``;
    the reference logs through Lightning's rank-zero logger)."""

    path = None

    def log(self, step: int, scalars: dict):
        pass

    def close(self):
        pass


@dataclass
class TrainerConfig:
    batch_size: int = 2048
    num_epochs: int = 20
    test_batch_size: int = 512
    exp_name: str = "exp"
    save_dir: str = "results"
    ckpt_path: str | None = None
    log_every: int = 50  # steps between scalar logs (and the end)
    # a torch.profiler window over steps [start, start + steps) (in place of
    # Lightning's profiler="simple", reference train.py:59); -1: none
    profile_start: int = -1
    profile_steps: int = 20


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return [_plain(v) for v in node]
    return node


class _BatchMover:
    """Host batches to the card: the four arrays packed as float32 columns
    (ts and labels by their bits) into one of two pinned buffers, one
    non-blocking copy, split again on the card. A buffer is written only
    after its previous copy has finished (an event per buffer)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self._bufs, self._events, self._k = [None, None], [None, None], 0

    def __call__(self, batch: dict) -> dict:
        rays = np.asarray(batch["rays"], np.float32)
        nr = rays.shape[1]
        cols = [rays, np.asarray(batch["ts"], np.int32).view(np.float32)[:, None],
                np.asarray(batch["labels"], np.int32).view(np.float32)[:, None],
                np.asarray(batch["rgbs"], np.float32)]
        width = sum(c.shape[1] for c in cols)
        if not self.pinned:
            packed = torch.from_numpy(np.concatenate(cols, axis=1)).to(self.device)
        else:
            k = self._k
            self._k ^= 1
            buf = self._bufs[k]
            if buf is None or buf.shape != (len(rays), width):
                buf = self._bufs[k] = torch.empty((len(rays), width), dtype=torch.float32,
                                                  pin_memory=True)
            if self._events[k] is not None:
                self._events[k].synchronize()
            np.concatenate(cols, axis=1, out=buf.numpy())
            packed = buf.to(self.device, non_blocking=True)
            self._events[k] = torch.cuda.Event()
            self._events[k].record()
        return {"rays": packed[:, :nr], "ts": packed[:, nr].contiguous().view(torch.int32),
                "labels": packed[:, nr + 1].contiguous().view(torch.int32),
                "rgbs": packed[:, nr + 2:]}


class Trainer:
    """The trainer of one scene: on one card (``device``, default the card),
    or as one rank of a data ``group`` on the group's card."""

    def __init__(self, cfg, tcfg: TrainerConfig, device=None, group=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.group = group
        self.device = group.device if group is not None else default_device(device)
        n_local = 1 if group is None else group.n_local
        if group is not None and group.n_model > 1:
            # as in JAX, a model axis is a library path (parallel/tensor.py)
            raise ValueError("the Trainer takes a data group; a model axis is not one")
        if tcfg.batch_size % n_local:
            raise ValueError(f"batch_size {tcfg.batch_size} does not divide over the "
                             f"{n_local} ranks of this host")
        self.is_main = is_main(group)
        self.use_device_pool = resolve_device_pool(getattr(cfg.TPU, "DEVICE_POOL", "auto"),
                                                   self.device)
        self.device_pool: DeviceRayPool | None = None
        # seconds of each band-cache pass (DeviceRayPool.attach_surface)
        self.attach_seconds: list = []

        from ..utils.scene import load_scene_bundle

        # the SFM grid drives the validation near / far and the refresh
        self.meta, self.scene, self.sfm_grid, self.sfm_dgrid = load_scene_bundle(
            cfg, device=self.device)
        self.train_level = surface_level(self.meta.scene_config,
                                         float(cfg.NEUCONW.TRAIN_VOXEL_SIZE))

        self.fc = field_config_from_cfg(cfg)
        self.lcfg = loss_config_from_cfg(cfg)
        # as the JAX Trainer (loop.py:120), the optimiser is built before
        # fit knows its length, so the schedule has total 0: a constant LR
        self.opt_spec, self.lr_schedule = make_optimizer(cfg, tcfg.batch_size)

        lid = get_label_id_mapping()
        rml = cfg.NEUCONW.RAY_MASK_LIST
        self.ray_mask_ids = tuple(lid[x] for x in rml) if rml else ()
        self.anneal_end = int(cfg.NEUCONW.ANNEAL_END)
        self.update_freq = int(cfg.NEUCONW.UPDATE_FREQ)
        self.save_freq = int(cfg.TRAINER.SAVE_FREQ)
        self.sdf_threshold = float(cfg.NEUCONW.SDF_THRESHOLD)

        # two step variants: warm-up (no fine grid) and surface-guided
        self._steps = {}
        self.fine_grid_host: VoxelGrid | None = None
        self.fine_dgrid = None
        # per refresh: step, seconds, n_candidates, n_kept, kept_frac, sweep_seconds
        self.refreshes: list = []
        self._scan_runs: list = []
        self.val_seconds: list = []
        self.profile_traces: list = []

        self.exp_dir = os.path.join(tcfg.save_dir, tcfg.exp_name)
        self.ckpt_dir = os.path.join(self.exp_dir, "checkpoints")
        self.logger = (MetricsLogger(os.path.join(self.exp_dir, "logs")) if self.is_main
                       else NullLogger())

        seed = int(cfg.TRAINER.SEED)
        self.state = init_state(self.fc, self.opt_spec, torch.Generator().manual_seed(seed),
                                self.device)
        if tcfg.ckpt_path:
            self._restore(tcfg.ckpt_path)
        self._move = _BatchMover(self.device)
        self._val_meta = None

    def _restore(self, path: str):
        """Parameters and step; the optimiser state and the fine grid where
        the file has them (a parameters-only file restores with fresh
        optimiser state, as ``loop.py:159-161`` does). The state must be
        of the optimiser TRAINER.OPTIMIZER names, else this raises."""
        restored = restore_checkpoint(path)
        self.state.model.load_state_dict(
            without_dead_entries(restored["state_dict"], self.fc.encode_a_bg), strict=True)
        self.state.step = restored["step"]
        if "optimizer" in restored:
            self.state.optimizer.load_state_dict(restored["optimizer"])
        if "fine_grid" in restored:
            self._set_fine_grid(restored["fine_grid"],
                                device_grid_from_host(restored["fine_grid"], self.device))

    def _set_fine_grid(self, host: VoxelGrid, dev):
        """Keep the fine grid; a refresh at the same level and cube is
        copied into the words and origin already on the card, which a
        captured step holds."""
        old = self.fine_dgrid
        self.fine_grid_host = host
        if (old is not None and old.occ.shape == dev.occ.shape
                and (old.scale, old.voxel_size) == (dev.scale, dev.voxel_size)):
            old.occ.copy_(dev.occ)
            old.origin.copy_(dev.origin)
        else:
            self.fine_dgrid = dev

    # ------------------------------ data ------------------------------

    def load_rays(self) -> RayPool:
        """The cache's rays: all splits, or in a group of several processes
        this process's share (``loop.py:175-187``)."""
        p = self.cfg.DATASET.PHOTOTOURISM
        split_root = os.path.join(self.cfg.DATASET.ROOT_DIR, p.CACHE_DIR, "splits")
        names = None
        if self.group is not None and self.group.num_processes > 1:
            names = local_split_names(split_root, self.group.num_processes,
                                      self.group.process_id)
        rays, rgbs = read_ray_cache(split_root, names, p.IMG_DOWNSCALE)
        return RayPool(rays, rgbs, with_semantics=p.WITH_SEMANTICS,
                       seed=int(self.cfg.TRAINER.SEED))

    # ------------------------------ steps ------------------------------

    def _get_step(self, with_fine: bool):
        key = "fine" if with_fine else "warm"
        if key not in self._steps:
            # training renders without the SFM near / far override
            # (loop.py:193-198)
            rcfg = render_config_from_cfg(self.cfg, sfm_level=-1,
                                          fine_level=self.train_level if with_fine else -1,
                                          nerf_far_override=False)
            self._steps[key] = make_train_step(self.fc, rcfg, self.lcfg, self.anneal_end,
                                               self.ray_mask_ids,
                                               seed=int(self.cfg.TRAINER.SEED) + 1,
                                               group=self.group)
        return self._steps[key]

    def refine_surface(self):
        """octree_update (reference neuconw_system.py:268-312); keeps the
        previous grid when no cell survives."""
        sc = self.meta.scene_config
        stats = {}
        t0 = time.perf_counter()
        host, dev = octree_update(
            self.state.model, self.fc, self.sfm_grid, sc,
            np.asarray(sc["origin"], np.float64), float(sc["radius"]),
            float(self.cfg.NEUCONW.TRAIN_VOXEL_SIZE), self.sdf_threshold, stats_out=stats,
            group=self.group)
        if host is not None:
            self._set_fine_grid(host, dev)
            self._attach_pool_surface()
        self.refreshes.append({"step": int(self.state.step),
                               "seconds": time.perf_counter() - t0, **stats})

    def _attach_pool_surface(self):
        """The pool's band cache for the current fine grid (one exact DDA
        pass over every row, K10 on the card), ``loop.py:211-224``."""
        if self.device_pool is not None and self.fine_dgrid is not None:
            t0 = time.perf_counter()
            self.device_pool.attach_surface(self.fine_dgrid, self.train_level)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.attach_seconds.append(time.perf_counter() - t0)

    def _get_scan_run(self, with_fine: bool, batch_size: int, n_inner: int):
        """The multi-step run of a phase; the warm-up's graph is freed once
        a fine grid exists (``loop.py:357-370``)."""
        key = ("scan_fine" if with_fine else "scan_warm", batch_size, n_inner)
        if with_fine:
            for k in [k for k in self._steps if isinstance(k, tuple) and k[0] == "scan_warm"]:
                self._steps.pop(k).release()
        if key not in self._steps:
            rcfg = render_config_from_cfg(self.cfg, sfm_level=-1,
                                          fine_level=self.train_level if with_fine else -1,
                                          nerf_far_override=False)
            self._steps[key] = make_scan_train_fn(
                self.fc, rcfg, self.lcfg, self.anneal_end, self.ray_mask_ids, batch_size,
                n_inner, seed=int(self.cfg.TRAINER.SEED) + 1)
            self._scan_runs.append(self._steps[key])
        return self._steps[key]

    def scan_runs(self) -> list:
        """Every multi-step run made so far, released ones included: their
        captures, replays and the launches one captured step records."""
        return list(self._scan_runs)

    # ------------------------------ loop ------------------------------

    def fit(self, pool: RayPool | None = None, max_steps: int | None = None):
        pool = pool or self.load_rays()
        if len(pool) == 0:
            raise ValueError("ray pool is empty — the cache holds no rays (all rays may have "
                             "missed the scene voxels during cache generation); check the "
                             "workspace/splits under DATASET.ROOT_DIR")
        bs = self.tcfg.batch_size
        steps_per_epoch = max(pool.epoch_batches(bs), 1)
        total = self.tcfg.num_epochs * steps_per_epoch
        if max_steps is not None:
            total = min(total, int(self.state.step) + max_steps)
        val_every = val_interval(float(self.cfg.TRAINER.VAL_FREQ), steps_per_epoch)
        log_every = max(int(self.tcfg.log_every), 1)

        device_pool = None
        if self.use_device_pool:
            g = self.group
            device_pool = DeviceRayPool(pool, self.device,
                                        sampling=str(getattr(self.cfg.TPU, "POOL_SAMPLING",
                                                             "epoch")),
                                        seed=int(self.cfg.TRAINER.SEED) + 3,
                                        shard=(0, 1) if g is None else (g.local_rank, g.n_local))
        self.device_pool = device_pool
        # a resumed fine grid: its band cache
        self._attach_pool_surface()
        scan_inner = int(getattr(self.cfg.TPU, "SCAN_INNER", 50))
        # a captured step takes no collective: one card only (loop.py:262-279)
        use_scan = device_pool is not None and self.group is None and scan_inner > 1
        if use_scan and device_pool.sampling == "epoch":
            # a window is scan_inner consecutive batches of one epoch
            scan_inner = min(scan_inner, device_pool.n // bs)
            use_scan = scan_inner > 1

        step_i = int(self.state.step)
        p0 = self.tcfg.profile_start
        p1 = p0 + self.tcfg.profile_steps
        prof = None
        # windowed throughput: the rate since the previous log, with the
        # validation renders kept out
        win_t, win_step = time.time(), step_i
        while step_i < total:
            if p0 >= 0 and self.is_main and prof is None and p0 <= step_i < p1:
                prof = self._start_profile()
            elif prof is not None and step_i >= p1:
                self._stop_profile(prof, p0)
                prof = None
            if self.update_freq > 0 and step_i > 0 and step_i % self.update_freq == 0:
                self.refine_surface()
            with_fine = self.fine_dgrid is not None
            # steps to the next refresh, save, validation, profile edge or the end
            edges = [e for e in (p0, p1) if p0 >= 0 and e > step_i]
            room = min([total] + edges + [(step_i // f + 1) * f for f in
                                          (self.update_freq, self.save_freq, val_every)
                                          if f > 0]) - step_i
            if use_scan and room >= scan_inner:
                run = self._get_scan_run(with_fine, bs, scan_inner)
                perm, start = device_pool.take_scan_window(bs, scan_inner)
                self.state, aux = run(self.state, self.scene, device_pool.data, self.fine_dgrid,
                                      self.sfm_dgrid, perm, start)
                step_i += scan_inner
            else:
                step = self._get_step(with_fine)
                batch = (device_pool.next_batch(bs) if device_pool is not None
                         else self._move(shard_rays(self.group, pool.next_batch(bs))))
                self.state, aux = step(self.state, self.scene, batch, self.fine_dgrid,
                                       self.sfm_dgrid)
                step_i += 1

            if step_i % log_every == 0 or step_i >= total:
                scalars = {k: float(v) for k, v in aux.items()}  # the only reads back
                # each span's last run (a captured dispatch's last step), read
                # once the loss read has waited for the device
                scalars.update({f"time/{k}_ms": v for k, v in span_ms().items()})
                now = time.time()
                scalars["rays_per_sec"] = bs * (step_i - win_step) / max(now - win_t, 1e-9)
                scalars["lr"] = self.lr_at(self.state.optimizer.count - 1)
                win_t, win_step = now, step_i
                self.logger.log(step_i, scalars)
            if self.save_freq > 0 and step_i % self.save_freq == 0:
                self.save(step_i)
            if val_every > 0 and step_i % val_every == 0 and self.meta.img_ids_train:
                self.validate(step_i)
                win_t = time.time()
        if prof is not None:
            self._stop_profile(prof, p0)
        self.save(step_i)
        return self.state

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, start: int) -> str:
        """Close the window and write its Chrome trace; returns the path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = os.path.join(self.exp_dir, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace_step{start}.json")
        prof.export_chrome_trace(path)
        self.profile_traces.append(path)
        return path

    def lr_at(self, count: int) -> float:
        """The LR of update ``count`` (from 0)."""
        s = self.lr_schedule
        return float(s(count) if callable(s) else s)

    def save(self, step: int):
        """The checkpoint of ``step``, written by rank 0; in a group every
        rank first checks the replicas, then waits for the write."""
        if self.group is not None:
            self.check_replicas()
        if self.is_main:
            save_checkpoint(os.path.join(self.ckpt_dir, f"step_{step}.ckpt"), self.state.model,
                            step, self.state.optimizer, self.fine_grid_host)
            snap = os.path.join(self.ckpt_dir, "config_snapshot.yaml")
            if not os.path.exists(snap):
                import yaml

                with open(snap, "w") as f:
                    yaml.safe_dump(_plain(self.cfg), f)
        barrier(self.group)

    def check_replicas(self) -> None:
        """Every rank's parameters bit for bit equal (a rank that stepped from
        its own gradient would differ): raises otherwise."""
        h = hashlib.sha256()
        for p in self.state.model.parameters():
            h.update(p.detach().cpu().numpy().tobytes())
        mine = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8).to(self.device)
        every = all_gather_rows(self.group, mine[None])
        if not bool((every == mine).all()):
            raise RuntimeError(f"rank {self.group.rank}: the ranks' parameters differ at step "
                               f"{self.state.step}")

    def validate(self, step: int) -> dict:
        """PSNR of the first training image at the validation downscale,
        rendered with the SFM near / far override (``loop.py:382-430``),
        and the inline mesh F-score where the workspace has gt.ply."""
        from ..datasets.phototourism import load_scene_meta
        from ..utils.scene import val_downscale
        from .validation import validation_report

        t0 = time.perf_counter()
        with_fine = self.fine_dgrid is not None
        key = "val_fine" if with_fine else "val_warm"
        if key not in self._steps:
            rcfg = render_config_from_cfg(
                self.cfg, sfm_level=self.sfm_grid.level,
                fine_level=self.train_level if with_fine else -1,
                nerf_far_override=bool(self.cfg.NEUCONW.NEAR_FAR_OVERRIDE))
            self._steps[key] = make_render_fn(self.fc, rcfg)
        if self._val_meta is None:
            self._val_meta = load_scene_meta(self.cfg.DATASET.ROOT_DIR, val_downscale(self.cfg),
                                             sfm_path=self.meta.sfm_path)
        val_id = self._val_meta.img_ids_train[0]  # reference phototourism.py:695
        # split over the ranks when they share a host and the chunk divides
        # over them; else every rank renders the whole image and rank 0
        # writes (loop.py:405-427, the reference's "validate same image for
        # all gpus")
        g = self.group
        split = (g is not None and g.num_processes == 1
                 and self.tcfg.test_batch_size % g.world_size == 0)
        metrics = validation_report(
            self._steps[key], self.state.model, self.scene, self._val_meta, val_id,
            chunk=self.tcfg.test_batch_size, fine_grid=self.fine_dgrid,
            sfm_grid=self.sfm_dgrid,
            out_dir=os.path.join(self.exp_dir, "val") if self.is_main else None, step=step,
            group=g if split else None)
        metrics.update(self._inline_mesh_eval(step))
        self.val_seconds.append(time.perf_counter() - t0)
        self.logger.log(step, metrics)
        return metrics

    def _inline_mesh_eval(self, step: int, dim: int = 128) -> dict:
        """The mesh at dim 128 over eval_bbx_detail and its F-score at 0.1
        against the workspace's gt.ply, when there is one (reference
        neuconw_system.py:466-531)."""
        gt_path = os.path.join(self.cfg.DATASET.ROOT_DIR, "gt.ply")
        if not os.path.exists(gt_path):
            return {}
        from ..evaluation import eval_mesh_arrays, sample_mesh_surface, transform_points
        from ..evaluation.geometry import bbx_crop
        from ..extraction import box_eval_grid, extract_mesh
        from ..utils.ply import read_ply

        sc = self.meta.scene_config
        bbx = sc.get("eval_bbx_detail", sc["eval_bbx"])
        mesh = extract_mesh(self.state.model, self.fc, box_eval_grid(bbx, dim),
                            np.asarray(sc["origin"], np.float64), float(sc["radius"]),
                            device=self.device, group=self.group)
        if mesh is None:
            return {"val/fscore": 0.0}
        # ground truth cropped to the detail box too (neuconw_system.py:517-527)
        gt = bbx_crop(read_ply(gt_path)["verts"], bbx)
        if len(gt) == 0:
            return {"val/fscore": 0.0}
        pred = bbx_crop(transform_points(
            sample_mesh_surface(mesh.verts, mesh.faces, min(len(gt) * 2, 200000)),
            np.asarray(sc["sfm2gt"])), bbx)
        return {"val/fscore": eval_mesh_arrays(pred, gt, threshold=0.1)["fscore"]}
