"""The training-time ray pool (``neuralrecon_w_tpu/datasets/cache.py:139-185``).

Splits the 12- or 11-column cache rows into the renderer's inputs
(reference datasets/phototourism.py:709-724): rays (10 columns: o, d,
near, far, depth, weight), ts, labels and rgbs; and draws shuffled
without-replacement batches from a ``numpy.random.RandomState(seed)``, the
same batches as the JAX package's ``RayPool`` for the same seed.
"""

from __future__ import annotations

import numpy as np


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
