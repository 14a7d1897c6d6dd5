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
    tn, tf, th = trv.grid_near_far(trv.device_grid_from_host(host, "cpu"), host.level,
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
    tt, th = trv.sampled_first_hit(trv.device_grid_from_host(host, "cpu"), host.level,
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
    got = trv.occupancy_lookup(trv.device_grid_from_host(host, "cpu"), host.level,
                               torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    # every occupied cell's centre reads occupied
    centers = ((host.coords + 0.5) / host.res * 2.0 - 1.0).astype(np.float32)
    assert trv.occupancy_lookup(trv.device_grid_from_host(host, "cpu"), host.level,
                                torch.from_numpy(centers)).all()


def test_plain_versions_count_the_words_the_kernels_read():
    """``touched`` counts one read a loop trip (K10) and one a walked sample
    inside the cube (K11): what chip_smoke's bytes bound counts once per
    distinct word. An empty level-2 grid, one ray along +x through every x
    cell at y = 1, z = 2: cells 16 x + 6, words 0, 0, 1, 1."""
    grid = trv.device_grid_from_host(VoxelGrid(2, np.zeros(3), 1.0,
                                               np.zeros((0, 3), np.int32)), "cpu")
    o = torch.tensor([[-2.0, -0.25, 0.25]])
    d = torch.tensor([[1.0, 0.0, 0.0]])
    touched = torch.zeros_like(grid.occ)
    _, _, hit = trv.dda_traverse_plain(grid.occ, 2, o, d, touched=touched)
    assert not hit.any() and touched.tolist() == [2, 2]
    # K11: samples at t = 0.5 + 2 (k + 0.5) / 8 walk x = -1.375 .. 0.375 by 0.25;
    # the 6 inside lie two to each of x cells 0, 1, 2
    touched = torch.zeros_like(grid.occ)
    trv.sampled_first_hit_plain(grid, 2, o, d, torch.tensor([0.5]), torch.tensor([2.5]), 8,
                                touched=touched)
    assert touched.tolist() == [4, 2]
    # a hit ends the walk: occupy x cell 1 (cell 22), the first sample there the 3rd inside
    grid = trv.device_grid_from_host(VoxelGrid(2, np.zeros(3), 1.0,
                                               np.array([[1, 1, 2]], np.int32)), "cpu")
    touched = torch.zeros_like(grid.occ)
    _, hit = trv.sampled_first_hit_plain(grid, 2, o, d, torch.tensor([0.5]),
                                         torch.tensor([2.5]), 8, touched=touched)
    assert hit.all() and touched.tolist() == [3, 0]
    touched = torch.zeros_like(grid.occ)
    trv.dda_traverse_plain(grid.occ, 2, o, d, first_only=True, touched=touched)
    assert touched.tolist() == [2, 0]


def test_high_bit_words_read_correctly():
    """Bit 31 of a word is the int32 sign bit in the port's storage."""
    n = 1 << 3
    idx = np.array([31, 63, 64 * 3 + 31])
    coords = np.stack([idx // (n * n), (idx // n) % n, idx % n], 1).astype(np.int32)
    host = VoxelGrid(3, np.zeros(3), 1.0, coords)
    grid = trv.device_grid_from_host(host, "cpu")
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
    dg, jg = trv.device_grid_from_host(got, "cpu"), trv.device_grid_from_host(want, "cpu")
    assert torch.equal(dg.occ, jg.occ) and (dg.scale, dg.voxel_size) == (jg.scale, jg.voxel_size)


# ------------------------------ two-level grid ------------------------------


def hier_pair(host):
    """JAX's HierGrid and the port's, of one host grid."""
    return jrv.hier_grid_from_host(host), trv.hier_grid_from_host(host, "cpu")


def shell_level12(n_rays=32, seed=11):
    """tests/test_ops.py:168's level-12 shell (20,000 points of a sphere of
    radius 1 in a cube of half-extent 2) and rays from below it aimed at
    its cells."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(20000, 3)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    res = 1 << 12
    cells = np.unique(np.clip(np.floor((pts * 0.5 + 1.0) / 2.0 * res), 0, res - 1)
                      .astype(np.int64), axis=0)
    host = VoxelGrid(12, np.zeros(3), 2.0, cells.astype(np.int32))
    origins = host.origin + np.array([0.0, 0.0, -2.5 * host.scale]) + rng.randn(n_rays, 3) * 0.3
    targets = host.centers_sfm()[rng.randint(0, len(cells), n_rays)]
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return host, origins.astype(np.float32), dirs.astype(np.float32)


def test_hier_grid_matches_jax_bit_for_bit():
    """meta (coarse words, rank bases) and fine words: JAX's uint32 bits, from
    the same cells in the port's own order."""
    host = random_grid(level=7, n_cells=900, seed=8)
    shuffled = VoxelGrid(host.level, host.origin, host.scale,
                         host.coords[np.random.default_rng(9).permutation(len(host.coords))])
    jg, tg = jrv.hier_grid_from_host(host), trv.hier_grid_from_host(shuffled, "cpu")
    np.testing.assert_array_equal(tg.meta.numpy().view(np.uint32), np.asarray(jg.meta))
    np.testing.assert_array_equal(tg.fine.numpy().view(np.uint32), np.asarray(jg.fine))
    assert (tg.scale, tg.voxel_size) == (float(jg.scale), float(jg.voxel_size))
    assert int(tg.meta[:, 0].ne(0).sum()) > 1  # more than one word: the rank is exercised


def assert_hier_matches(host, o, d, first_only, atol=1e-5):
    jg, tg = hier_pair(host)
    o_norm = ((o - host.origin) / host.scale).astype(np.float32)
    want = jrv.dda_traverse_hier(jg, host.level, jnp.asarray(o_norm), jnp.asarray(d),
                                 first_only)
    got = trv.dda_traverse_hier(tg, host.level, torch.from_numpy(o_norm), torch.from_numpy(d),
                                first_only)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)
    return got


@pytest.mark.parametrize("level,n_cells", [(5, 40), (7, 300), (9, 800)])
@pytest.mark.parametrize("first_only", [False, True])
def test_hier_dda_matches_jax(level, n_cells, first_only):
    host = random_grid(level=level, n_cells=n_cells, seed=level)
    o, d = random_rays(r=96, seed=level + 1)
    _, _, hit = assert_hier_matches(host, o, d, first_only)
    assert hit.any() and (~hit).any()
    # and the oracle
    tn, tf, th = trv.grid_near_far(trv.hier_grid_from_host(host, "cpu"), level,
                                   torch.from_numpy(o), torch.from_numpy(d), first_only)
    bn, bf, bh = jrv.brute_force_near_far(host, o, d)
    np.testing.assert_array_equal(th.numpy(), bh)
    np.testing.assert_allclose(tn.numpy()[bh], bn[bh], atol=1e-4, rtol=1e-3)
    if not first_only:
        np.testing.assert_allclose(tf.numpy()[bh], bf[bh], atol=1e-4, rtol=1e-3)


def test_hier_dda_level12_shell_matches_jax():
    host, o, d = shell_level12()
    t_first, _, hit = assert_hier_matches(host, o, d, first_only=True)
    assert int(hit.sum()) > 28
    tg = trv.hier_grid_from_host(host, "cpu")
    assert tg.meta.numel() * 4 + tg.fine.numel() * 4 < 200 * 2**20  # flat: 8 GiB


def test_hier_first_only_and_parallel_miss():
    host = random_grid(level=6, n_cells=60, seed=3)
    tg = trv.hier_grid_from_host(host, "cpu")
    o, d = random_rays(seed=4)
    nf, _, vf = trv.grid_near_far(tg, 6, torch.from_numpy(o), torch.from_numpy(d))
    n1, _, v1 = trv.grid_near_far(tg, 6, torch.from_numpy(o), torch.from_numpy(d), True)
    assert torch.equal(vf, v1) and torch.equal(nf, n1)
    o_miss = torch.tensor([[0.0, 0.0, -50.0]]) + torch.from_numpy(host.origin).float()
    near, far, valid = trv.grid_near_far(tg, 6, o_miss, torch.tensor([[0.0, 1.0, 0.0]]))
    assert not valid.any() and float(near[0]) == 0.0 and float(far[0]) == 0.0


def test_make_device_grid_picks_two_levels_from_level_9():
    assert trv.HIER_LEVEL_DEFAULT == jrv.HIER_LEVEL_DEFAULT == 9
    for level, kind in ((8, trv.DeviceGrid), (9, trv.HierGrid)):
        host = random_grid(level=level, n_cells=50, seed=level)
        assert isinstance(trv.make_device_grid(host, device="cpu"), kind)
    assert isinstance(trv.make_device_grid(random_grid(), True, "cpu"), trv.HierGrid)


def test_hier_plain_counts_the_words_k12_reads():
    """touched: one meta row a step of an active ray, one fine word a step
    inside an occupied block. Level 4, one occupied cell (2, 2, 12) in
    block (0, 0, 1); a ray along +z at that cell's x, y walks the empty
    block (0, 0, 0) in one step, then fine cells 8 .. 15 of block 1."""
    host = VoxelGrid(4, np.zeros(3), 1.0, np.array([[2, 2, 12]], np.int32))
    hg = trv.hier_grid_from_host(host, "cpu")
    o = torch.tensor([[-0.6875, -0.6875, -2.0]])  # cell centre of x, y = 2
    d = torch.tensor([[0.0, 0.0, 1.0]])
    touched = (torch.zeros(hg.meta.shape[0], dtype=torch.int32),
               torch.zeros_like(hg.fine))
    t_first, t_last, hit = trv.dda_traverse_hier_plain(hg, 4, o, d, touched=touched)
    assert hit.all() and abs(float(t_first[0]) - 2.5) < 1e-5 and float(t_last[0]) == float(
        t_first[0])
    assert touched[0].tolist() == [9] and int(touched[1].sum()) == 8


# cuts after the first steps, around eight (the batch that K10 computes
# ahead) and past a meta row's 32 blocks
HIER_CUTS = (1, 2, 7, 8, 9, 33)


def full_block_grid(level, seed=0, per_block=3):
    """A two-level host grid with every block occupied, each by a few cells."""
    rng = np.random.default_rng(seed)
    n_c = 1 << (level - 3)
    blocks = np.stack(np.meshgrid(*[np.arange(n_c)] * 3, indexing="ij"), -1).reshape(-1, 1, 3)
    coords = (blocks * 8 + rng.integers(0, 8, (len(blocks), per_block, 3))).reshape(-1, 3)
    return VoxelGrid(level, np.array([0.1, -0.3, 0.2]), 1.5,
                     np.unique(coords, axis=0).astype(np.int32))


def inside_rays(host, r=96, seed=0):
    """Rays from inside the cube in SFM units: half from occupied cells'
    centres, half from random points, in random directions."""
    rng = np.random.default_rng(seed)
    centres = host.centers_sfm()[rng.integers(0, len(host.coords), r // 2)]
    anywhere = host.origin + rng.uniform(-0.95, 0.95, (r - r // 2, 3)) * host.scale
    d = rng.standard_normal((r, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([centres, anywhere]).astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("first_only", [False, True])
@pytest.mark.parametrize("max_steps", HIER_CUTS)
@pytest.mark.parametrize("level,n_cells", [(4, 60), (9, 800)])
def test_hier_dda_max_steps_cuts_match_jax(level, n_cells, max_steps, first_only):
    """The plain version K12 is held to, cut after max_steps steps
    (HIER_CUTS), against JAX's loop with the same cut."""
    host = random_grid(level=level, n_cells=n_cells, seed=30 + level)
    o, d = random_rays(r=96, seed=31 + level)
    jg, tg = hier_pair(host)
    o_norm = ((o - host.origin) / host.scale).astype(np.float32)
    want = jrv.dda_traverse_hier(jg, level, jnp.asarray(o_norm), jnp.asarray(d), first_only,
                                 max_steps)
    steps = torch.zeros(len(o), dtype=torch.int32)
    got = trv.dda_traverse_hier_plain(tg, level, torch.from_numpy(o_norm), torch.from_numpy(d),
                                      first_only, max_steps, steps_out=steps)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    # each ray's march is the uncut one's, cut after max_steps steps
    full = torch.zeros(len(o), dtype=torch.int32)
    trv.dda_traverse_hier_plain(tg, level, torch.from_numpy(o_norm), torch.from_numpy(d),
                                first_only, steps_out=full)
    assert torch.equal(steps, full.clamp(max=max_steps))
    assert int(full.max()) > max_steps or max_steps == HIER_CUTS[-1]


@pytest.mark.parametrize("first_only", [False, True])
@pytest.mark.parametrize("level", [4, 6])
def test_hier_dda_every_block_occupied_matches_jax(level, first_only):
    """Every block occupied (no block step at all), from outside the cube
    and from inside it."""
    host = full_block_grid(level, seed=level)
    hg = trv.hier_grid_from_host(host, "cpu")
    assert int(hg.fine.numel()) == 16 * (1 << (3 * (level - 3)))
    for o, d in (random_rays(r=64, seed=40 + level), inside_rays(host, seed=41 + level)):
        _, _, hit = assert_hier_matches(host, o, d, first_only)
        assert hit.any()


@pytest.mark.parametrize("first_only", [False, True])
@pytest.mark.parametrize("level,n_cells", [(5, 40), (9, 800)])
def test_hier_dda_rays_inside_the_cube_match_jax(level, n_cells, first_only):
    """Rays that start inside the cube, in occupied cells and elsewhere."""
    host = random_grid(level=level, n_cells=n_cells, seed=50 + level)
    o, d = inside_rays(host, seed=51 + level)
    _, _, hit = assert_hier_matches(host, o, d, first_only)
    assert hit.any() and (~hit).any()


def split_of(hg, level, o, d, first_only=False):
    """(block steps, fine steps) of rays (o, d) from the plain version's
    touched counts, and its per-ray steps."""
    touched = (torch.zeros(hg.meta.shape[0], dtype=torch.int32), torch.zeros_like(hg.fine))
    steps = torch.zeros(o.shape[0], dtype=torch.int32)
    trv.dda_traverse_hier_plain(hg, level, o, d, first_only, touched=touched, steps_out=steps)
    fine_steps = int(touched[1].sum())
    assert int(steps.sum()) == int(touched[0].sum())
    return int(touched[0].sum()) - fine_steps, fine_steps, steps


def test_hier_touched_split_on_hand_made_grids():
    """The block / fine split read from touched: an empty grid gives block
    steps only, one per block crossed; a ray through one fully occupied
    block gives one fine step per fine cell it crosses, counted exactly."""
    level, n_c = 5, 4
    empty = VoxelGrid(level, np.zeros(3), 1.0, np.zeros((0, 3), np.int32))
    hg = trv.hier_grid_from_host(empty, "cpu")
    # along +z at a block's centre: n_c blocks; an oblique ray: one step a block crossed
    o = torch.tensor([[-0.75, -0.75, -2.0], [-0.9, -0.8, -0.95]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.3, 0.2, 0.9327379]])
    d = d / d.norm(dim=-1, keepdim=True)
    blocks, fine_steps, steps = split_of(hg, level, o, d)
    assert fine_steps == 0 and steps[0] == n_c and blocks == int(steps.sum())
    # the oblique ray's blocks, counted by their boundary planes crossed (float64)
    o64, d64 = o[1].double().numpy(), d[1].double().numpy()
    t_out = float(np.min((np.where(d64 > 0, 1.0, -1.0) - o64) / d64))
    a, b = (o64 + 1) / 2 * n_c, (o64 + d64 * t_out + 1) / 2 * n_c
    assert steps[1] == 1 + int(np.abs(np.floor(np.minimum(b, n_c - 1e-9)) - np.floor(a)).sum())

    # block (1, 2, 1) full: its 512 cells
    cells = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
    full = VoxelGrid(level, np.zeros(3), 1.0, (cells + np.array([8, 16, 8])).astype(np.int32))
    hg = trv.hier_grid_from_host(full, "cpu")
    w = 2.0 / (1 << level)
    lo = np.array([8, 16, 8]) * w - 1.0  # the block's low corner, normalised
    cases = [(lo + np.array([3.5, 2.5, -4.0]) * w, np.array([0.0, 0.0, 1.0])),
             (lo + np.array([-3.2, 1.3, -2.9]) * w, np.array([0.61, 0.29, 0.55]))]
    for o_, d_ in cases:
        d_ = d_ / np.linalg.norm(d_)
        o_t = torch.tensor(o_[None], dtype=torch.float32)
        d_t = torch.tensor(d_[None], dtype=torch.float32)
        blocks, fine_steps, _ = split_of(hg, level, o_t, d_t)
        # the fine cells the ray crosses inside the block: one plus the cell
        # planes it crosses there (a generic ray crosses no two at once)
        with np.errstate(divide="ignore"):
            t0, t1 = (lo - o_) / d_, (lo + 8 * w - o_) / d_
        s_in, s_out = np.max(np.minimum(t0, t1)), np.min(np.maximum(t0, t1))
        a = (o_ + d_ * s_in - lo) / w
        b = (o_ + d_ * s_out - lo) / w
        crossed = 1 + int(np.abs(np.floor(np.clip(b, 0, 8 - 1e-9))
                                 - np.floor(np.clip(a, 0, 8 - 1e-9))).sum())
        assert fine_steps == crossed, (fine_steps, crossed)
        assert blocks > 0


def test_hier_plain_global_reads_follow_the_mask():
    """global_reads: below HIER_MASK_FROM a read for each step outside the
    held block, and one more for each occupied block entered; from it, no
    read in an empty mask block, so fewer reads than block steps on a
    sparse grid; the mask is the OR of the cells over 64^3-cell blocks."""
    o, d = random_rays(r=48, seed=61)
    for level in (trv.HIER_MASK_FROM - 1, trv.HIER_MASK_FROM):
        host = random_grid(level=level, n_cells=300, seed=60)
        hg = trv.hier_grid_from_host(host, "cpu")
        o_norm = torch.from_numpy(((o - host.origin) / host.scale).astype(np.float32))
        steps, reads = (torch.zeros(len(o), dtype=torch.int32) for _ in range(2))
        touched = (torch.zeros(hg.meta.shape[0], dtype=torch.int32), torch.zeros_like(hg.fine))
        trv.dda_traverse_hier_plain(hg, level, o_norm, torch.from_numpy(d), touched=touched,
                                    steps_out=steps, global_reads=reads)
        block_steps = int(steps.sum()) - int(touched[1].sum())
        if level < trv.HIER_MASK_FROM:
            assert int(reads.sum()) > block_steps
        else:
            assert 0 < int(reads.sum()) < block_steps
        assert bool((reads <= 2 * steps).all())
        shift = level - trv.MASK_LEVEL
        m = host.coords.astype(np.int64) >> shift
        m = (m[:, 0] << (2 * trv.MASK_LEVEL)) | (m[:, 1] << trv.MASK_LEVEL) | m[:, 2]
        want = np.zeros(1 << (3 * trv.MASK_LEVEL - 5), np.uint32)
        np.bitwise_or.at(want, m >> 5, np.uint32(1) << (m & 31).astype(np.uint32))
        if level >= trv.HIER_MASK_FROM:
            np.testing.assert_array_equal(trv.hier_mask(hg, level).numpy().view(np.uint32), want)


def test_hier_mask_below_the_prepass_is_metas_words():
    """At MASK_LEVEL + 3 and below a two-level grid's blocks are no more than
    the mask's: K12's mask is meta's coarse words themselves."""
    for level in (3, 4, trv.MASK_LEVEL + 3):
        host = random_grid(level=level, n_cells=200, seed=level)
        hg = trv.hier_grid_from_host(host, "cpu")
        assert torch.equal(trv.hier_mask(hg, level), hg.meta[:, 0].contiguous())


def test_mask_constants_agree_with_the_kernel_source():
    """The wrappers' copies of ray_voxel.cu's mask constants (MASK_LEVEL,
    MASK_FROM, HIER_MASK_FROM) are the kernels' own."""
    import re
    from pathlib import Path

    src = (Path(trv.__file__).parent.parent / "csrc" / "ray_voxel.cu").read_text()
    for name in ("MASK_LEVEL", "MASK_FROM", "HIER_MASK_FROM"):
        found = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert found == [str(getattr(trv, name))], (name, found)


# --------------------------- K10's coarse mask ---------------------------


def clustered_grid(level, seed=0):
    """Occupied cells in six clusters and a thin scatter (up to ~3,000
    cells), so that blocks of the edges tested are empty and occupied both."""
    rng = np.random.default_rng(seed)
    n = 1 << level
    centres = rng.integers(0, n, (6, 3))
    spread = max(n // 16, 1)
    coords = [np.clip(c + rng.integers(-spread, spread + 1, (400, 3)), 0, n - 1)
              for c in centres]
    coords.append(rng.integers(0, n, (min(n ** 3 // 4096 + 1, 500), 3)))
    return VoxelGrid(level, np.zeros(3), 1.0,
                     np.unique(np.concatenate(coords), axis=0).astype(np.int32))


@pytest.mark.parametrize("edge", ["k10", "b8", "beyond"])
@pytest.mark.parametrize("level", list(range(1, 11)))
def test_coarse_words_match_a_numpy_or_over_blocks(level, edge):
    """coarse_words_plain against the OR over blocks of the host grid's
    cells: at K10's block edge (the cells themselves at MASK_LEVEL and
    below), at B = 8, and at a B whose block exceeds the grid (one bit, set
    if any cell is)."""
    host = clustered_grid(level, seed=level)
    shift = {"k10": trv.mask_shift(level), "b8": 3, "beyond": level + 1}[edge]
    lc = max(level - shift, 0)
    nc = 1 << lc
    blocks = host.coords.astype(np.int64) >> (level - lc)
    cidx = (blocks[:, 0] * nc + blocks[:, 1]) * nc + blocks[:, 2]
    want = np.zeros(max(nc ** 3 // 32, 1), np.uint32)
    np.bitwise_or.at(want, cidx >> 5, np.uint32(1) << (cidx & 31).astype(np.uint32))
    occ = torch.from_numpy(host.occupancy_words().view(np.int32))
    got = trv.coarse_words_plain(occ, level, shift).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    if edge == "k10":
        np.testing.assert_array_equal(trv.coarse_mask(occ, level).numpy().view(np.uint32), want)
    if nc >= 8:  # blocks empty and occupied both
        assert 0 < int(np.unpackbits(want.view(np.uint8)).sum()) < nc ** 3


@pytest.mark.parametrize("level", list(range(3, 11)))
def test_coarse_words_at_b8_are_jax_hier_coarse_words(level):
    """At B = 8 the mask is the coarse level of JAX's two-level grid: bit
    for bit its ``hier_grid_from_host(grid).meta[:, 0]``."""
    host = clustered_grid(level, seed=20 + level)
    occ = torch.from_numpy(host.occupancy_words().view(np.int32))
    np.testing.assert_array_equal(trv.coarse_words_plain(occ, level, 3).numpy().view(np.uint32),
                                  np.asarray(jrv.hier_grid_from_host(host).meta)[:, 0])


@pytest.mark.parametrize("first_only", [False, True])
@pytest.mark.parametrize("level", [5, 8, 9])
def test_plain_dda_counts_trips_and_global_reads(level, first_only):
    """steps_out: each ray's trips (their sum is touched's); global_reads:
    the trips K10 reads from device memory, every one below MASK_FROM,
    some and not all on a clustered grid from it up, all of them on a grid
    whose every block is occupied. The CPU wrapper fills steps_out as the
    kernel does."""
    host = clustered_grid(level, seed=level)
    o, d = random_rays(r=256, seed=level)
    o = ((o - np.array([0.3, -0.2, -4.0], np.float32)) * 0.25).astype(np.float32)
    o[:, 2] -= 1.5
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    occ = torch.from_numpy(host.occupancy_words().view(np.int32))
    trips, reads, wrapped = (torch.zeros(256, dtype=torch.int32) for _ in range(3))
    touched = torch.zeros_like(occ)
    want = trv.dda_traverse_plain(occ, level, o, d, first_only, touched=touched,
                                  steps_out=trips, global_reads=reads)
    got = trv.dda_traverse(occ, level, o, d, first_only, steps_out=wrapped)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(wrapped, trips) and int(touched.sum()) == int(trips.sum()) > 0
    assert bool((reads <= trips).all())
    if level < trv.MASK_FROM:
        assert torch.equal(reads, trips)
        return
    assert 0 < int(reads.sum()) < int(trips.sum())
    full = torch.full_like(occ, -1)  # every cell occupied: every trip reads
    trips_full, reads_full = torch.zeros_like(trips), torch.zeros_like(trips)
    trv.dda_traverse_plain(full, level, o, d, first_only, steps_out=trips_full,
                           global_reads=reads_full)
    assert torch.equal(reads_full, trips_full)


def test_plain_sampled_hit_counts_the_samples_walked():
    """steps_out of the plain K11: the first occupied inside sample's index
    + 1, else n_samples, against a numpy walk of every ray's samples."""
    host = random_grid()
    o, d = random_rays(r=64, seed=3)
    grid = trv.device_grid_from_host(host, "cpu")
    o_n = ((o - host.origin) / host.scale).astype(np.float32)
    rng = np.random.default_rng(4)
    t_lo = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    t_hi = (t_lo + rng.uniform(1.0, 3.0, 64)).astype(np.float32)
    k = 96
    steps, wrapped = torch.zeros(64, dtype=torch.int32), torch.zeros(64, dtype=torch.int32)
    args = (grid, host.level, torch.from_numpy(o_n), torch.from_numpy(d),
            torch.from_numpy(t_lo), torch.from_numpy(t_hi), k)
    _, hit = trv.sampled_first_hit_plain(*args, steps_out=steps)
    trv.sampled_first_hit(*args, steps_out=wrapped)
    rel = ((np.arange(k, dtype=np.float32) + np.float32(0.5)) / np.float32(k))
    t = t_lo[:, None] + (t_hi - t_lo)[:, None] * rel[None]
    p = o_n[:, None, :] + d[:, None, :] * t[..., None]
    inside = np.abs(p).max(-1) < 1.0
    n = host.res
    c = np.clip(np.floor((p + 1.0) * (n / 2.0)), 0, n - 1).astype(np.int64)
    occupied = np.isin((c[..., 0] * n + c[..., 1]) * n + c[..., 2],
                       (host.coords[:, 0].astype(np.int64) * n + host.coords[:, 1]) * n
                       + host.coords[:, 2]) & inside
    want = np.where(occupied.any(1), occupied.argmax(1) + 1, k)
    np.testing.assert_array_equal(steps.numpy(), want)
    assert torch.equal(wrapped, steps) and 0 < int(hit.sum()) < 64
