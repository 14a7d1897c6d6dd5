"""PyTorch port, the device ray pool (``datasets/cache.DeviceRayPool``) on
the CPU: epoch and with-replacement sampling, the multi-step dispatch's
windows and their errors, the surface-band cache against the direct query
and against the JAX package's ``_band_query``, and the resolution of
TPU.DEVICE_POOL (tests/test_training.py:381-447, :610)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralrecon_w_tpu.datasets import cache as jax_cache  # noqa: E402
from neuralrecon_w_tpu.ops import ray_voxel as jrv  # noqa: E402
from neuralrecon_w_tpu.ops.voxel_grid import grid_from_points as jax_grid_from_points  # noqa: E402
from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool, RayPool, _band_query  # noqa: E402
from neuralrecon_w_tpu_torch.ops import ray_voxel as trv  # noqa: E402
from neuralrecon_w_tpu_torch.training.loop import resolve_device_pool  # noqa: E402

torch.set_num_threads(1)


def id_pool(n=512, seed=0):
    """Rows whose o_x is the row's index."""
    rays = np.random.RandomState(seed).rand(n, 12).astype(np.float32)
    rays[:, 0] = np.arange(n)
    return RayPool(rays, np.random.RandomState(seed + 1).rand(n, 3).astype(np.float32))


def row_ids(batch):
    return batch["rays"][:, 0].numpy().astype(int)


def test_pool_holds_the_host_pool_rows():
    pool = id_pool(256)
    dp = DeviceRayPool(pool, "cpu")
    assert dp.n == len(dp) == 256
    assert dp.epoch_batches(64) == pool.epoch_batches(64) == 4
    for k, v in (("rays", pool.rays), ("ts", pool.ts), ("labels", pool.labels),
                 ("rgbs", pool.rgbs)):
        np.testing.assert_array_equal(dp.data[k].numpy(), v)
    b = dp.next_batch(64)
    assert b["rays"].shape == (64, 10) and b["ts"].dtype == torch.int32
    ids = row_ids(b)
    np.testing.assert_array_equal(b["rgbs"].numpy(), pool.rgbs[ids])
    np.testing.assert_array_equal(b["ts"].numpy(), pool.ts[ids])


def test_epoch_sampling_covers_every_row_once_an_epoch():
    n, bs = 512, 64
    dp = DeviceRayPool(id_pool(n), "cpu", sampling="epoch", seed=5)
    epochs = []
    for _ in range(3):
        ids = np.concatenate([row_ids(dp.next_batch(bs)) for _ in range(n // bs)])
        assert len(ids) == n and len(set(ids.tolist())) == n
        epochs.append(ids)
    # each epoch reshuffles: same coverage, another order
    assert not np.array_equal(epochs[0], epochs[1])
    assert not np.array_equal(epochs[1], epochs[2])
    # an epoch that cannot fill a batch starts the next (drop_last)
    dp2 = DeviceRayPool(id_pool(100), "cpu", seed=5)
    seen = [row_ids(dp2.next_batch(32)) for _ in range(4)]
    assert len(set(np.concatenate(seen[:3]).tolist())) == 96
    # the same seed gives the same stream
    again = DeviceRayPool(id_pool(n), "cpu", sampling="epoch", seed=5)
    np.testing.assert_array_equal(row_ids(again.next_batch(bs)), epochs[0][:bs])


def test_replacement_sampling_draws_pool_rows():
    n = 128
    pool = id_pool(n)
    dp = DeviceRayPool(pool, "cpu", sampling="replacement", seed=3)
    a, b = dp.next_batch(64), dp.next_batch(64)
    assert not np.array_equal(row_ids(a), row_ids(b))
    for batch in (a, b):
        ids = row_ids(batch)
        assert ids.min() >= 0 and ids.max() < n
        np.testing.assert_array_equal(batch["rays"].numpy(), pool.rays[ids])
    assert dp.take_scan_window(64, 2) == (None, None)
    with pytest.raises(ValueError):
        DeviceRayPool(pool, "cpu", sampling="stratified")


def test_scan_windows_are_disjoint_and_reshuffle():
    """take_scan_window hands out consecutive windows of one epoch's
    permutation; crossing the epoch's end reshuffles, a window larger than
    the pool raises (the JAX pool's test_device_ray_pool_scan_window)."""
    n = 512
    dp = DeviceRayPool(id_pool(n), "cpu", sampling="epoch")
    perm, start = dp.take_scan_window(64, 4)
    first = perm.clone()
    perm2, start2 = dp.take_scan_window(64, 4)
    assert start == 0 and start2 == 256 and perm2 is perm
    assert len(set(first.tolist())) == n  # a permutation: the windows are disjoint
    # 256 rows left < 512 needed: a new permutation in the same tensor, cursor 0
    perm3, start3 = dp.take_scan_window(64, 8)
    assert start3 == 0 and perm3 is perm and not torch.equal(perm3, first)
    assert sorted(perm3.tolist()) == list(range(n))
    with pytest.raises(ValueError, match="exceeds"):
        dp.take_scan_window(64, 9)
    # next_batch and the windows share one cursor: the epoch is spent, so
    # the next batch starts a new permutation
    spent = perm3.clone()
    b = dp.next_batch(64)
    assert not torch.equal(perm, spent)
    np.testing.assert_array_equal(row_ids(b), perm[:64].numpy())


def shell_grid():
    pts = np.random.RandomState(3).randn(3000, 3)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)  # a unit-sphere shell
    return jax_grid_from_points(pts, [-2, -2, -2], [2, 2, 2], voxel_size=0.25, expand=1)


def band_rows(n=256, seed=0):
    """tests/test_training.py:617-629's rows: rays from above the shell
    toward its centre, axis-parallel ones and origins inside cells among
    them."""
    rs = np.random.RandomState(seed)
    o = rs.randn(n, 3).astype(np.float32) * 0.1 + np.array([0, 0, 2.2], np.float32)
    d = -o + rs.randn(n, 3).astype(np.float32) * 0.05
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:8] = [0.0, 0.0, -1.0]
    o[8:16] = rs.randn(8, 3).astype(np.float32) * 0.02 + np.array([0.0, 0.0, 1.0], np.float32)
    rows = np.concatenate([
        o, d, np.full((n, 1), 0.5, np.float32), np.full((n, 1), 4.0, np.float32),
        rs.randint(0, 8, (n, 1)).astype(np.float32), rs.randint(0, 4, (n, 1)).astype(np.float32),
        np.full((n, 1), 2.0, np.float32), rs.rand(n, 1).astype(np.float32)], axis=1)
    return RayPool(rows, rs.rand(n, 3).astype(np.float32))


def test_attach_surface_matches_query_and_jax():
    """The band cache of every row equals grid_near_far(first_only=True)
    bit for bit, and the JAX package's _band_query on the same rays and
    grid exactly: the plain DDA runs the JAX loop's float32 arithmetic
    step for step. Gathered batches carry it;
    re-attaching writes the same tensors; detach_surface drops it."""
    host = shell_grid()
    pool = band_rows()
    dp = DeviceRayPool(pool, "cpu")
    grid = trv.device_grid_from_host(host, "cpu")
    dp.attach_surface(grid, host.level, chunk=100)
    surf_t, surf_hit = dp.data["surf_t"], dp.data["surf_hit"]
    rays = dp.data["rays"]
    want, _, want_hit = trv.grid_near_far(grid, host.level, rays[:, 0:3], rays[:, 3:6],
                                          first_only=True)
    assert torch.equal(surf_t, want) and torch.equal(surf_hit, want_hit)
    assert surf_hit.any() and (~surf_hit).any()
    js, jh = jax_cache._band_query(jrv.device_grid_from_host(host), host.level,
                                   jnp.asarray(pool.rays))
    np.testing.assert_array_equal(surf_hit.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(surf_t.numpy(), np.asarray(js))
    qs, qh = _band_query(grid, host.level, rays)
    assert torch.equal(qs, surf_t) and torch.equal(qh, surf_hit)

    b = dp.next_batch(64)
    ids = [int(np.flatnonzero((pool.rays == row).all(axis=1))[0]) for row in b["rays"].numpy()]
    assert torch.equal(b["surf_t"], surf_t[ids]) and torch.equal(b["surf_hit"], surf_hit[ids])

    ptr = (surf_t.data_ptr(), surf_hit.data_ptr())
    dp.detach_surface()
    assert "surf_t" not in dp.data and "surf_t" not in dp.next_batch(64)
    dp.attach_surface(grid, host.level)
    assert (dp.data["surf_t"].data_ptr(), dp.data["surf_hit"].data_ptr()) == ptr
    assert torch.equal(dp.data["surf_t"], want)


@pytest.mark.parametrize("option,device,want", [
    ("auto", "cuda", True), ("auto", "cpu", False), ("AUTO", "cuda:0", True),
    (True, "cpu", True), (False, "cuda", False), ("true", "cpu", True), ("false", "cuda", False),
    (1, "cpu", True), (0, "cuda", False)])
def test_device_pool_resolution(option, device, want):
    """'auto' follows the device (the JAX package's follows its
    accelerator); true and false force the pool."""
    assert resolve_device_pool(option, device) is want


def test_device_pool_resolution_rejects_other_words():
    with pytest.raises(ValueError, match="DEVICE_POOL"):
        resolve_device_pool("sometimes", "cpu")
