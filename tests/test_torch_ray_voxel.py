"""PyTorch port, flat occupancy-grid traversal: parity with the JAX
lax.while_loop DDA and sampled queries, and with the brute-force oracle."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralrecon_w_tpu.ops import ray_voxel as jrv  # noqa: E402
from neuralrecon_w_tpu.ops.voxel_grid import VoxelGrid  # noqa: E402
from neuralrecon_w_tpu_torch.ops import ray_voxel as trv  # noqa: E402

torch.set_num_threads(1)


def random_grid(level=5, n_cells=300, seed=0):
    rng = np.random.default_rng(seed)
    n = 1 << level
    coords = np.unique(rng.integers(n // 4, 3 * n // 4, (n_cells, 3)), axis=0)
    return VoxelGrid(level, np.array([0.3, -0.2, 0.1]), 2.0, coords.astype(np.int32))


def random_rays(r=64, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((r, 3)) * 0.3 + np.array([0.3, -0.2, -4.0])
    target = rng.standard_normal((r, 3)) * 0.8 + np.array([0.3, -0.2, 0.1])
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4] = [[0.0, 0.0, 1.0]] * 4  # axis-aligned rays (zero direction components)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("first_only", [False, True])
def test_grid_near_far_matches_jax_and_oracle(first_only):
    host = random_grid()
    o, d = random_rays()
    jn, jf, jh = jrv.grid_near_far(jrv.device_grid_from_host(host), host.level,
                                   jnp.asarray(o), jnp.asarray(d), first_only=first_only)
    tn, tf, th = trv.grid_near_far(trv.device_grid_from_host(host), host.level,
                                   torch.from_numpy(o), torch.from_numpy(d), first_only)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5, rtol=0)
    assert th.any() and (~th).any()
    bn, bf, bh = jrv.brute_force_near_far(host, o, d)
    np.testing.assert_array_equal(th.numpy(), bh)
    np.testing.assert_allclose(tn.numpy(), bn, atol=1e-4, rtol=0)
    if not first_only:
        np.testing.assert_allclose(tf.numpy(), bf, atol=1e-4, rtol=0)


def test_sampled_first_hit_matches_jax():
    host = random_grid(level=6, n_cells=2000, seed=2)
    o, d = random_rays(seed=3)
    o_norm = (o - host.origin) / host.scale
    t_lo = np.full((len(o),), 1.0, np.float32)
    t_hi = np.full((len(o),), 3.5, np.float32)
    jt, jh = jrv.sampled_first_hit(jrv.device_grid_from_host(host), host.level,
                                   jnp.asarray(o_norm, jnp.float32), jnp.asarray(d),
                                   jnp.asarray(t_lo), jnp.asarray(t_hi), 256)
    tt, th = trv.sampled_first_hit(trv.device_grid_from_host(host), host.level,
                                   torch.from_numpy(o_norm.astype(np.float32)),
                                   torch.from_numpy(d), torch.from_numpy(t_lo),
                                   torch.from_numpy(t_hi), 256)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6, rtol=0)
    assert th.any()


def test_occupancy_lookup_matches_jax():
    host = random_grid(level=5, n_cells=800, seed=4)
    pts = np.random.default_rng(5).uniform(-1.1, 1.1, (7, 40, 3)).astype(np.float32)
    want = np.asarray(jrv.occupancy_lookup(jrv.device_grid_from_host(host), host.level,
                                           jnp.asarray(pts)))
    got = trv.occupancy_lookup(trv.device_grid_from_host(host), host.level,
                               torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    # every occupied cell's centre reads occupied
    centers = ((host.coords + 0.5) / host.res * 2.0 - 1.0).astype(np.float32)
    assert trv.occupancy_lookup(trv.device_grid_from_host(host), host.level,
                                torch.from_numpy(centers)).all()


def test_high_bit_words_read_correctly():
    """Bit 31 of a word is the int32 sign bit in the port's storage."""
    n = 1 << 3
    idx = np.array([31, 63, 64 * 3 + 31])
    coords = np.stack([idx // (n * n), (idx // n) % n, idx % n], 1).astype(np.int32)
    host = VoxelGrid(3, np.zeros(3), 1.0, coords)
    grid = trv.device_grid_from_host(host)
    assert grid.occ.dtype == torch.int32 and int(grid.occ.min()) < 0
    lin = torch.from_numpy(idx)
    assert trv._bit(grid.occ, lin).all()
    assert not trv._bit(grid.occ, lin - 1).any()


@pytest.mark.parametrize("expand", [0, 1])
def test_grid_from_points_matches_jax(expand):
    """The port's grid_from_points: the JAX package's level, cube and
    occupied cells (its own cell order)."""
    from neuralrecon_w_tpu.ops.voxel_grid import grid_from_points as jax_grid_from_points
    from neuralrecon_w_tpu_torch.ops.voxel_grid import grid_from_points

    rng = np.random.default_rng(6)
    pts = rng.standard_normal((400, 3))
    pts *= rng.uniform(0.8, 1.2, (400, 1)) / np.linalg.norm(pts, axis=-1, keepdims=True)
    args = (pts, [-1.2, -1.0, -1.1], [1.3, 1.0, 0.9], 0.05, expand, 1.1)
    want, got = jax_grid_from_points(*args), grid_from_points(*args)
    assert (got.level, got.scale, got.voxel_size) == (want.level, want.scale, want.voxel_size)
    np.testing.assert_array_equal(got.origin, want.origin)
    assert got.coords.dtype == np.int32 and len(got.coords) == len(want.coords) > 0
    np.testing.assert_array_equal(got.occupancy_words(), want.occupancy_words())
    dg, jg = trv.device_grid_from_host(got), trv.device_grid_from_host(want)
    assert torch.equal(dg.occ, jg.occ) and (dg.scale, dg.voxel_size) == (jg.scale, jg.voxel_size)
