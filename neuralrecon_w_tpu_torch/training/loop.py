"""Training orchestration for one scene on one card
(``neuralrecon_w_tpu/training/loop.py``; reference train.py:16-71,
lightning_modules/neuconw_system.py:60-546).

One Python loop drives: host ``RayPool`` batches -> the train step ->
the surface refresh every UPDATE_FREQ steps -> checkpoints every SAVE_FREQ
steps -> validation every VAL_FREQ (a fraction of an epoch, or a step
count). The loop reads nothing back from the card between log points:
scalars come to the host every ``log_every`` steps and at the end, and a
batch goes to the card as one non-blocking copy from pinned memory.

What the JAX package's ``Trainer`` does on a TPU and this one does not:
the device ray pool and its surface-band cache (``TPU.DEVICE_POOL: true``
raises; 'auto' is the host pool, as the JAX package's 'auto' is off a
TPU), the scan over many steps per dispatch, the device mesh and
multi-process runs, and the profiler window (``profile_start``).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import field_config_from_cfg, render_config_from_cfg
from ..datasets.cache import RayPool, read_ray_cache
from ..datasets.mask_utils import get_label_id_mapping
from ..device import default_device
from ..ops.ray_voxel import device_grid_from_host
from ..ops.voxel_grid import VoxelGrid
from ..tools.convert import without_dead_entries
from .checkpoint import restore_checkpoint, save_checkpoint
from .losses import loss_config_from_cfg
from .schedule import make_optimizer
from .step import init_state, make_render_fn, make_train_step
from .surface import octree_update, surface_level

DEVICE_POOL_ITEM = ("the device ray pool is ROADMAP.md Queue 1's device-pool item "
                    "(DeviceRayPool and its surface-band cache); set TPU.DEVICE_POOL "
                    "to 'auto' or false for the host pool")


def val_interval(val_freq: float, steps_per_epoch: int) -> int:
    """Steps between validations, Lightning's val_check_interval's two
    meanings (reference train.py:57): at most 1.0 a fraction of an epoch,
    above 1 a step count."""
    if val_freq > 1.0:
        return int(val_freq)
    return max(int(steps_per_epoch * val_freq), 1)


class MetricsLogger:
    """Scalars as JSON lines in ``<log_dir>/metrics.jsonl`` (in place of
    the reference's TestTubeLogger, train.py:38-42). The JAX package also
    mirrors them to TensorBoard; the port does not."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, scalars: dict):
        rec = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


@dataclass
class TrainerConfig:
    batch_size: int = 2048
    num_epochs: int = 20
    test_batch_size: int = 512
    exp_name: str = "exp"
    save_dir: str = "results"
    ckpt_path: str | None = None
    log_every: int = 50  # steps between scalar logs (and the end)


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
    """Single-card trainer for one scene; ``device`` defaults to the card."""

    def __init__(self, cfg, tcfg: TrainerConfig, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = default_device(device)
        pool_opt = getattr(cfg.TPU, "DEVICE_POOL", "auto")
        if pool_opt != "auto" and pool_opt:  # the JAX Trainer's test (loop.py:246-250)
            raise NotImplementedError(DEVICE_POOL_ITEM)

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
        self.val_seconds: list = []

        self.exp_dir = os.path.join(tcfg.save_dir, tcfg.exp_name)
        self.ckpt_dir = os.path.join(self.exp_dir, "checkpoints")
        self.logger = MetricsLogger(os.path.join(self.exp_dir, "logs"))

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
        optimiser state, as ``loop.py:159-161`` does)."""
        restored = restore_checkpoint(path)
        self.state.model.load_state_dict(
            without_dead_entries(restored["state_dict"], self.fc.encode_a_bg), strict=True)
        self.state.step = restored["step"]
        if "optimizer" in restored:
            self.state.optimizer.opt.load_state_dict(restored["optimizer"]["state"])
            self.state.optimizer.count = int(restored["optimizer"]["count"])
        if "fine_grid" in restored:
            self.fine_grid_host = restored["fine_grid"]
            self.fine_dgrid = device_grid_from_host(self.fine_grid_host, self.device)

    # ------------------------------ data ------------------------------

    def load_rays(self) -> RayPool:
        p = self.cfg.DATASET.PHOTOTOURISM
        split_root = os.path.join(self.cfg.DATASET.ROOT_DIR, p.CACHE_DIR, "splits")
        rays, rgbs = read_ray_cache(split_root, None, p.IMG_DOWNSCALE)
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
                                               seed=int(self.cfg.TRAINER.SEED) + 1)
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
            float(self.cfg.NEUCONW.TRAIN_VOXEL_SIZE), self.sdf_threshold, stats_out=stats)
        if host is not None:
            self.fine_grid_host, self.fine_dgrid = host, dev
        self.refreshes.append({"step": int(self.state.step),
                               "seconds": time.perf_counter() - t0, **stats})

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

        step_i = int(self.state.step)
        # windowed throughput: the rate since the previous log, with the
        # validation renders kept out
        win_t, win_step = time.time(), step_i
        while step_i < total:
            if self.update_freq > 0 and step_i > 0 and step_i % self.update_freq == 0:
                self.refine_surface()
            step = self._get_step(self.fine_dgrid is not None)
            batch = self._move(pool.next_batch(bs))
            self.state, aux = step(self.state, self.scene, batch, self.fine_dgrid,
                                   self.sfm_dgrid)
            step_i += 1

            if step_i % log_every == 0 or step_i >= total:
                scalars = {k: float(v) for k, v in aux.items()}  # the only reads back
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
        self.save(step_i)
        return self.state

    def lr_at(self, count: int) -> float:
        """The LR of update ``count`` (from 0)."""
        s = self.lr_schedule
        return float(s(count) if callable(s) else s)

    def save(self, step: int):
        save_checkpoint(os.path.join(self.ckpt_dir, f"step_{step}.ckpt"), self.state.model,
                        step, self.state.optimizer, self.fine_grid_host)
        snap = os.path.join(self.ckpt_dir, "config_snapshot.yaml")
        if not os.path.exists(snap):
            import yaml

            with open(snap, "w") as f:
                yaml.safe_dump(_plain(self.cfg), f)

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
        metrics = validation_report(
            self._steps[key], self.state.model, self.scene, self._val_meta, val_id,
            chunk=self.tcfg.test_batch_size, fine_grid=self.fine_dgrid,
            sfm_grid=self.sfm_dgrid, out_dir=os.path.join(self.exp_dir, "val"), step=step)
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
                            device=self.device)
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
