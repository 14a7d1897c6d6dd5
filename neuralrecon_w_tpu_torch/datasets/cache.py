"""The ray cache on disk and the training-time ray pool
(``neuralrecon_w_tpu/datasets/cache.py:1-185``).

The cache layout is the reference's (reference
tools/prepare_data/prepare_data_cache.py:78-210, datasets/phototourism.py:467-515):
  <root>/<cache_dir>/splits/split_{i}/rays{downscale}.h5   key "rays"
  <root>/<cache_dir>/splits/split_{i}/rgbs{downscale}.h5   key "rgbs"
  <root>/<cache_dir>/splits/rays{downscale}_meta_info.json
    {"data_length", "chunk_length", "n_trunks"}
or, with ``cache_type`` 'npz', ``rays{downscale}.npz`` / ``rgbs{downscale}.npz``
(array ``arr_0``) in each split. Rows are padded to a multiple of the split
count by repeating seeded random rows (reference prepare_data_cache.py:189-198).
A process of an ``n``-process run loads a disjoint seeded share of the
splits (``local_split_names``, seed 6, reference datasets/data.py:83-100).

``RayPool`` splits the 12- or 11-column cache rows into the renderer's
inputs (reference datasets/phototourism.py:709-724): rays (10 columns: o,
d, near, far, depth, weight), ts, labels and rgbs; and draws shuffled
without-replacement batches from a ``numpy.random.RandomState(seed)``, the
same batches as the JAX package's ``RayPool`` for the same seed.
"""

from __future__ import annotations

import json
import os

import numpy as np

DEFAULT_N_SPLITS = 64


def _h5(path, mode="r"):
    import h5py

    return h5py.File(path, mode)


def write_ray_cache(rays_per_image: list, rgbs_per_image: list, root_dir: str,
                    cache_dir: str = "cache_sgs", n_splits: int = DEFAULT_N_SPLITS,
                    img_downscale: int = 1, cache_type: str = "h5", seed: int = 0) -> str:
    """Concatenate the per-image ray and rgb arrays, pad, and write
    ``n_splits`` splits and the meta info. Returns the splits' root."""
    rays = np.concatenate(rays_per_image, axis=0).astype(np.float32)
    rgbs = np.concatenate(rgbs_per_image, axis=0).astype(np.float32)
    n = len(rays)
    pad = (-n) % n_splits
    if pad:
        idx = np.random.RandomState(seed).choice(n, pad, replace=pad > n)
        rays = np.concatenate([rays, rays[idx]], axis=0)
        rgbs = np.concatenate([rgbs, rgbs[idx]], axis=0)
    total = len(rays)
    chunk = total // n_splits

    split_root = os.path.join(root_dir, cache_dir, "splits")
    os.makedirs(split_root, exist_ok=True)
    for i in range(n_splits):
        d = os.path.join(split_root, f"split_{i}")
        os.makedirs(d, exist_ok=True)
        sl = slice(i * chunk, (i + 1) * chunk)
        for key, arr in (("rays", rays), ("rgbs", rgbs)):
            path = os.path.join(d, f"{key}{img_downscale}.{cache_type}")
            if cache_type == "h5":
                with _h5(path, "w") as f:
                    f.create_dataset(key, data=arr[sl], chunks=True)
            else:
                np.savez_compressed(path, arr[sl])
    meta = {"data_length": total, "chunk_length": chunk, "n_trunks": n_splits}
    for key in ("rays", "rgbs"):
        with open(os.path.join(split_root, f"{key}{img_downscale}_meta_info.json"), "w") as f:
            json.dump(meta, f)
    return split_root


def _split_dirs(split_root: str) -> list:
    return sorted(d for d in os.listdir(split_root)
                  if os.path.isdir(os.path.join(split_root, d)))


def local_split_names(split_root: str, world_size: int, rank: int, seed: int = 6):
    """The splits of process ``rank`` of ``world_size``: a seeded
    permutation cut into disjoint shares, the first ``n % world_size``
    ranks taking one more (``cache.py:79-103``)."""
    names = _split_dirs(split_root)
    n = len(names)
    if world_size > n:
        raise ValueError(f"world_size {world_size} exceeds the {n} cache splits; "
                         "regenerate the cache with more splits")
    perm = np.random.RandomState(seed).permutation(names)
    base, rem = divmod(n, world_size)
    start = rank * base + min(rank, rem)
    count = base + (1 if rank < rem else 0)
    return list(perm[start:start + count])


def read_ray_cache(split_root: str, cache_names: list | None = None, img_downscale: int = 1):
    """The named splits (all when None) concatenated, h5 or npz, as
    float32 (rays, rgbs)."""
    if cache_names is None:
        cache_names = _split_dirs(split_root)
    all_rays, all_rgbs = [], []
    for name in cache_names:
        d = os.path.join(split_root, name)
        ray_h5 = os.path.join(d, f"rays{img_downscale}.h5")
        if os.path.exists(ray_h5):
            with _h5(ray_h5) as f:
                all_rays.append(f["rays"][:])
            with _h5(os.path.join(d, f"rgbs{img_downscale}.h5")) as f:
                all_rgbs.append(f["rgbs"][:])
        else:
            all_rays.append(np.load(os.path.join(d, f"rays{img_downscale}.npz"))["arr_0"])
            all_rgbs.append(np.load(os.path.join(d, f"rgbs{img_downscale}.npz"))["arr_0"])
    return (np.concatenate(all_rays, 0).astype(np.float32),
            np.concatenate(all_rgbs, 0).astype(np.float32))


class RayPool:
    """In-memory ray pool producing fixed-size training batches (numpy)."""

    def __init__(self, rays: np.ndarray, rgbs: np.ndarray, with_semantics=True, seed: int = 0):
        self.with_semantics = with_semantics and rays.shape[1] >= 12
        if self.with_semantics:
            self.rays = np.concatenate([rays[:, :8], rays[:, 10:12]], axis=1)
            self.labels = rays[:, 9].astype(np.int32)
        else:
            self.rays = np.concatenate([rays[:, :8], rays[:, 9:11]], axis=1)
            self.labels = np.zeros((len(rays),), np.int32)
        self.ts = rays[:, 8].astype(np.int32)
        self.rgbs = rgbs
        self._rng = np.random.RandomState(seed)
        self._order = None
        self._cursor = 0

    def __len__(self):
        return len(self.rays)

    def epoch_batches(self, batch_size: int) -> int:
        return len(self.rays) // batch_size

    def next_batch(self, batch_size: int) -> dict:
        """Shuffled without-replacement batch; a new permutation when the
        epoch cannot fill one (drop_last)."""
        if self._order is None or self._cursor + batch_size > len(self._order):
            self._order = self._rng.permutation(len(self.rays))
            self._cursor = 0
        idx = self._order[self._cursor:self._cursor + batch_size]
        self._cursor += batch_size
        return self.gather(idx)

    def gather(self, idx: np.ndarray) -> dict:
        return {"rays": self.rays[idx], "ts": self.ts[idx], "labels": self.labels[idx],
                "rgbs": self.rgbs[idx]}
