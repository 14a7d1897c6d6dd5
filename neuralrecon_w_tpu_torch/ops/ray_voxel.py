"""Ray / occupancy-grid intersection (``neuralrecon_w_tpu/ops/ray_voxel.py``):
kernels K10 (the exact DDA through a flat grid), K11 (the sampled
first-hit query) and K12 (the exact DDA through a two-level grid) in
``csrc/ray_voxel.cu``, and their plain PyTorch versions.

The JAX package marches a packed occupancy bitfield with a branch-free
Amanatides-Woo DDA inside ``lax.while_loop``, and samples the band's
interval densely for the sampled query. On a CUDA tensor ``dda_traverse``
launches K10 (one thread a ray, its reads issued a batch of steps at a
time; from MASK_FROM up through a coarse occupancy mask that a pre-pass
builds in every call, ``coarse_mask``), ``sampled_first_hit`` K11 (one
warp a ray, 32 samples a round) and ``dda_traverse_hier`` K12 (one thread
a ray: from HIER_MASK_FROM up through the same mask, of its blocks, so a
step in an empty mask block reads nothing; an occupied block's fine words
read once), or raise; on a CPU tensor they run their plain versions:
``dda_traverse_plain`` and ``dda_traverse_hier_plain``, Python loops of
whole-batch tensor steps that ask the device whether any ray is still
active every ``_SYNC_EVERY`` steps, and ``sampled_first_hit_plain`` over
the (R, n_samples) sample buffer (the mask's: ``coarse_words_plain``).
Each kernel equals its plain version bit for bit.

Two grid layouts. ``DeviceGrid`` is the flat bitfield of 2^{3L} bits.
``HierGrid`` is JAX's two-level one: a bitfield of 8^3-cell blocks and 512
bits for each occupied block, found by a rank lookup; a flat level-12 grid
would be 2^36 bits (8 GiB), the two-level one ~32 MiB plus 64 B a block.
``make_device_grid`` picks the two-level one from ``HIER_LEVEL_DEFAULT``
(level 9) up, as JAX does, and ``traverse`` / ``grid_near_far`` take either.
The reprojection filter (``evaluation/reproj_filter.py``, up to level 12)
goes through them. Serving, the ray cache, the training step's fine-grid
query and the device pool's band cache keep the flat grid: JAX's Trainer
ships its level-10 fine grid as a ``HierGrid`` (``training/loop.py:170``),
but the two march to the same results, and the flat level-10 grid is 128 MiB.

Contract (get_near_far parity): depths are ray parameters of the ENTRY
points of the first / last intersected voxel, in SFM units; rays whose
first entry is <= 1e-4 (origin inside a voxel) count as misses with
near = far = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import default_device
from .build import check, kernels, stream_handle
from .voxel_grid import VoxelGrid

_INF = 1e10
# steps between host checks of "is any ray still marching"
_SYNC_EVERY = 16
# K10's coarse mask (csrc/ray_voxel.cu): one bit a B^3 block of cells, B =
# 2^(level - MASK_LEVEL) above MASK_LEVEL, so 2^18 bits (32 KB, in shared
# memory); at MASK_LEVEL and below the grid is its own mask. K10 marches
# through it from level MASK_FROM up (grids of 16 MiB and more)
MASK_LEVEL = 6
MASK_FROM = 9
# K12 marches through the same mask, of its blocks (meta's coarse words),
# from this level up: the lowest whose blocks outnumber the mask's bits
HIER_MASK_FROM = 10
_MASK_WORDS = 1 << (3 * MASK_LEVEL - 5)


class DeviceGrid(NamedTuple):
    """Flat occupancy bitfield on the device (the level is static)."""

    occ: torch.Tensor  # (2^{3L}/32,) int32: the uint32 words, bit for bit
    origin: torch.Tensor  # (3,) float32, cube center in SFM coords
    scale: float  # cube half-extent (float32 value)
    voxel_size: float  # cell edge in SFM units (float32 value)


def device_grid_from_host(grid: VoxelGrid, device=None, occ: torch.Tensor | None = None
                          ) -> DeviceGrid:
    """A host grid (``ops/voxel_grid.VoxelGrid``, or the JAX package's,
    which has the same fields) on ``device`` (default: the card); ``occ``,
    its occupancy words where the caller built them on ``device``."""
    device = default_device(device)
    return DeviceGrid(
        occ=(torch.from_numpy(grid.occupancy_words().view(np.int32)).to(device) if occ is None
             else occ),
        origin=torch.as_tensor(np.asarray(grid.origin, np.float32), device=device),
        scale=float(np.float32(grid.scale)),
        voxel_size=float(np.float32(grid.voxel_size)),
    )


def _bit(occ: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Occupancy bit of linear cell indices (int64)."""
    word = occ[idx >> 5]
    return ((word >> (idx & 31).to(torch.int32)) & 1) == 1


def _default_steps(level: int) -> int:
    return 3 * (1 << level) + 2


def dda_traverse(occ: torch.Tensor, level: int, rays_o: torch.Tensor,
                 rays_d: torch.Tensor, first_only: bool = False,
                 max_steps: int | None = None, steps_out: torch.Tensor | None = None):
    """March rays (R, 3) in grid-normalized coordinates through the
    [-1, 1]^3 grid. Returns (t_first, t_last, hit); misses hold 0. CPU
    tensors take the plain version; CUDA tensors launch K10 (after its
    mask's pre-pass from MASK_FROM up, which the count leaves out), or
    raise. ``steps_out`` ((R,) int32 on the rays' device) receives each
    ray's loop trips."""
    if max_steps is None:
        max_steps = _default_steps(level)
    r = rays_o.shape[0]
    if steps_out is not None and (steps_out.shape != (r,) or steps_out.dtype != torch.int32
                                  or steps_out.device != rays_o.device):
        raise ValueError("dda_traverse: steps_out must be (R,) int32 on the rays' device")
    if rays_o.device.type == "cpu":
        return dda_traverse_plain(occ, level, rays_o, rays_d, first_only, max_steps,
                                  steps_out=steps_out)
    if rays_o.device.type != "cuda":
        raise ValueError(f"tensors on {rays_o.device}")
    _check_rays("dda_traverse", occ, level, rays_o, rays_d)
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    t_first = torch.empty(r, dtype=torch.float32, device=rays_o.device)
    t_last = torch.empty_like(t_first)
    hit = torch.empty(r, dtype=torch.bool, device=rays_o.device)
    mask = torch.empty(_MASK_WORDS, dtype=torch.int32, device=rays_o.device)  # the pre-pass's
    err = kernels().nw_dda(occ.data_ptr(), mask.data_ptr(), level,
                           rays_o.data_ptr(), rays_d.data_ptr(), r, int(first_only),
                           int(max_steps), t_first.data_ptr(), t_last.data_ptr(), hit.data_ptr(),
                           None if steps_out is None else steps_out.data_ptr(),
                           stream_handle(rays_o.device))
    check("nw_dda", err)
    dda_traverse.launches += 1
    return t_first, t_last, hit


dda_traverse.launches = 0


def mask_shift(level: int) -> int:
    """log2 of the edge B of K10's mask blocks at ``level``."""
    return max(level - MASK_LEVEL, 0)


def coarse_mask(occ: torch.Tensor, level: int) -> torch.Tensor:
    """K10's coarse mask of a level-``level`` grid's words
    (``coarse_words_plain`` at ``mask_shift(level)``): above MASK_LEVEL on
    a CUDA tensor K10's pre-pass (csrc/ray_voxel.cu ``coarse_kernel``),
    which ``dda_traverse`` runs before every launch from MASK_FROM up; at
    MASK_LEVEL and below the words themselves. CPU tensors take the plain
    version."""
    if occ.device.type == "cpu":
        return coarse_words_plain(occ, level, mask_shift(level))
    if occ.device.type != "cuda":
        raise ValueError(f"tensors on {occ.device}")
    n_words = max((1 << (3 * level)) // 32, 1)
    if occ.dtype != torch.int32 or occ.shape != (n_words,) or not occ.is_contiguous():
        raise ValueError(f"coarse_mask: a level-{level} grid is ({n_words},) int32 words")
    if level <= MASK_LEVEL:
        return occ
    mask = torch.empty(_MASK_WORDS, dtype=torch.int32, device=occ.device)
    check("nw_coarse_mask", kernels().nw_coarse_mask(occ.data_ptr(), level, mask.data_ptr(),
                                                     stream_handle(occ.device)))
    return mask


def coarse_words_plain(occ: torch.Tensor, level: int, shift: int) -> torch.Tensor:
    """The plain version of K10's pre-pass at any block edge B = 2^shift:
    bit c is set where any cell of block c is occupied, the blocks in the
    linear (x, y, z) order of a level max(level - shift, 0) grid (one block
    covers the whole grid where B^3 exceeds it), packed 32 to an int32
    word as the grid's cells are. At shift 3 these are the coarse words of
    the two-level grid (``hier_grid_from_host``'s ``meta[:, 0]``). Runs a
    slab of blocks along x at a time, so a level-10 grid needs no dense
    copy."""
    n = 1 << level
    lc = max(level - shift, 0)
    b, nc = n >> lc, 1 << lc
    if level < 5:  # a word spans rows: the bits one by one
        shifts = torch.arange(32, dtype=torch.int32, device=occ.device)
        cells = ((occ[:, None] >> shifts) & 1).reshape(-1)[:n ** 3] == 1
        blocks = cells.reshape(nc, b, nc, b, nc, b).any(5).any(3).any(1)
    else:
        rows = occ.reshape(n, n, n // 32)
        slabs = []
        for x0 in range(0, n, b):
            w = rows[x0:x0 + b]
            if b >= 32:  # a word lies inside one block
                z = (w != 0).reshape(b, n, n // b, b // 32).any(3)
            else:  # a word covers 32 / b blocks, b bits each
                z = torch.stack([((w >> (g * b)) & ((1 << b) - 1)) != 0
                                 for g in range(32 // b)], dim=-1).reshape(b, n, n // b)
            slabs.append(z.reshape(b, nc, b, nc).any(2).any(0))
        blocks = torch.stack(slabs)
    bits = blocks.reshape(-1).to(torch.int64)
    bits = torch.nn.functional.pad(bits, (0, -bits.numel() % 32)).reshape(-1, 32)
    words = (bits << torch.arange(32, device=occ.device)).sum(1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _check_rays(name: str, occ, level: int, rays_o, rays_d, *rows):
    r = rays_o.shape[0]
    tensors = (rays_o, rays_d) + rows
    if any(t.dtype != torch.float32 or t.device != rays_o.device for t in tensors):
        raise ValueError(f"{name} takes float32 tensors on one device")
    if rays_o.shape != (r, 3) or rays_d.shape != (r, 3) or any(t.shape != (r,) for t in rows):
        raise ValueError(f"{name}: rays (R, 3), rows (R,) of one R")
    n_words = max((1 << (3 * level)) // 32, 1)
    if occ.dtype != torch.int32 or occ.device != rays_o.device or occ.shape != (n_words,) \
            or not occ.is_contiguous():
        raise ValueError(f"{name}: a level-{level} grid is ({n_words},) int32 words on the "
                         "rays' device")


def dda_traverse_plain(occ: torch.Tensor, level: int, rays_o: torch.Tensor,
                       rays_d: torch.Tensor, first_only: bool = False,
                       max_steps: int | None = None, touched: torch.Tensor | None = None,
                       steps_out: torch.Tensor | None = None,
                       global_reads: torch.Tensor | None = None):
    """The plain PyTorch version of K10 (same contract as dda_traverse).

    Each step is a handful of whole-batch tensor ops, so its cost is the
    host's launch rate: the cell is carried as a linear index, the grid
    exit as per-axis counts of steps left, and the step axis by argmin +
    gather / scatter. The f32 arithmetic is the JAX loop's, so the
    results are the same bit for bit. ``touched`` (occ's shape, int32)
    gains one at a word for every step that tests it: one a loop trip of
    each ray. ``steps_out`` ((R,) int32) receives each ray's loop trips,
    ``global_reads`` ((R,) int32) the trips on which K10 reads the word
    from device memory: every trip below MASK_FROM, from it up those whose
    block of K10's coarse mask is occupied."""
    n = 1 << level
    if max_steps is None:
        max_steps = _default_steps(level)
    r = rays_o.shape[0]
    cell_w = 2.0 / n

    d = torch.where(torch.abs(rays_d) < 1e-12, torch.full_like(rays_d, 1e-12), rays_d)
    inv_d = 1.0 / d
    t0 = (-1.0 - rays_o) * inv_d
    t1 = (1.0 - rays_o) * inv_d
    t_enter = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_exit = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_enter = torch.clamp(t_enter, min=0.0)
    active = t_exit > t_enter

    pos = rays_o + d * (t_enter + 1e-6)[:, None]
    cell = torch.clamp(torch.floor((pos + 1.0) / cell_w), 0, n - 1).to(torch.int64)
    up = d > 0
    next_bound = (cell + up.to(torch.int64)).float() * cell_w - 1.0
    tmax = (next_bound - rays_o) * inv_d
    tdelta = cell_w * torch.abs(inv_d)
    # a step along axis a moves the linear index by +-stride[a] and uses
    # one of the steps left before the ray leaves the grid on that axis
    stride = torch.tensor([n * n, n, 1], dtype=torch.int64, device=rays_o.device)
    idx_step = torch.where(up, stride, -stride)
    left = torch.where(up, n - 1 - cell, cell)
    idx = (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2]
    minus_one = torch.full((r, 1), -1, dtype=torch.int64, device=rays_o.device)

    t_cur = t_enter
    first = torch.full((r,), _INF, device=rays_o.device)
    last = torch.full((r,), -_INF, device=rays_o.device)
    trips = torch.zeros(r, dtype=torch.int32, device=rays_o.device)
    reads = torch.zeros_like(trips)
    s = mask_shift(level)
    mask = (coarse_words_plain(occ, level, s) if global_reads is not None
            and level >= MASK_FROM else None)
    for i in range(max_steps):
        if i % _SYNC_EVERY == 0 and not bool(active.any()):
            break
        # the index is in range while the ray is active; clamp for the rest
        at = torch.clamp(idx, 0, n * n * n - 1)
        occ_hit = _bit(occ, at) & active
        if touched is not None:
            touched.index_add_(0, at >> 5, active.to(torch.int32))
        trips += active.to(torch.int32)
        if mask is not None:  # the cell's block in the level-MASK_LEVEL mask
            bx, by, bz = (at >> 2 * level) >> s, ((at >> level) & (n - 1)) >> s, (at & (n - 1)) >> s
            c = (bx << 2 * MASK_LEVEL) | (by << MASK_LEVEL) | bz
            reads += (_bit(mask, c) & active).to(torch.int32)
        else:
            reads += active.to(torch.int32)
        first = torch.where(occ_hit & (first >= _INF), t_cur, first)
        last = torch.where(occ_hit, t_cur, last)

        axis = torch.argmin(tmax, dim=-1, keepdim=True)  # the first axis on ties
        t_next = torch.gather(tmax, 1, axis)[:, 0]
        tmax = tmax.scatter_add(1, axis, torch.gather(tdelta, 1, axis))
        idx = idx + torch.gather(idx_step, 1, axis)[:, 0]
        left = left.scatter_add(1, axis, minus_one)
        active = active & (torch.gather(left, 1, axis)[:, 0] >= 0) & (t_next <= t_exit)
        if first_only:
            active = active & (first >= _INF)
        t_cur = t_next
    if steps_out is not None:
        steps_out.copy_(trips)
    if global_reads is not None:
        global_reads.copy_(reads)
    hit = first < _INF
    zero = torch.zeros_like(first)
    return torch.where(hit, first, zero), torch.where(hit, last, zero), hit


def _cell_index(level: int, pts: torch.Tensor) -> torch.Tensor:
    """Linear cell indices (int64) of points in grid-normalized [-1, 1]^3."""
    n = 1 << level
    c = torch.clamp(torch.floor((pts + 1.0) * (n / 2.0)), 0, n - 1).long()
    return (c[..., 0] * n + c[..., 1]) * n + c[..., 2]


def occupancy_lookup(grid: DeviceGrid, level: int, pts: torch.Tensor) -> torch.Tensor:
    """Occupancy of points in grid-normalized [-1, 1]^3, any leading
    shape (flat branch of ``ray_voxel.py:298-323``)."""
    return _bit(grid.occ, _cell_index(level, pts))


def sampled_first_hit(grid: DeviceGrid, level: int, rays_o, rays_d, t_lo, t_hi,
                      n_samples: int = 1024, steps_out: torch.Tensor | None = None):
    """First-hit parameter by dense occupancy sampling of [t_lo, t_hi]
    (``ray_voxel.py:326-358``): the first of the n_samples midpoints
    inside the cube and occupied. Returns (t_first, hit), t_first = 0 on
    miss. CPU tensors take the plain version; CUDA tensors launch K11,
    which walks the samples in order, 32 a round, and stops after the
    round that holds the first hit, or raise. ``steps_out`` ((R,) int32 on
    the rays' device): samples walked a ray, up to and including its first
    hit, else n_samples."""
    r = rays_o.shape[0]
    if steps_out is not None and (steps_out.shape != (r,) or steps_out.dtype != torch.int32
                                  or steps_out.device != rays_o.device):
        raise ValueError("sampled_first_hit: steps_out must be (R,) int32 on the rays' device")
    if rays_o.device.type == "cpu":
        return sampled_first_hit_plain(grid, level, rays_o, rays_d, t_lo, t_hi, n_samples,
                                       steps_out=steps_out)
    if rays_o.device.type != "cuda":
        raise ValueError(f"tensors on {rays_o.device}")
    t_lo, t_hi = t_lo.contiguous(), t_hi.contiguous()
    _check_rays("sampled_first_hit", grid.occ, level, rays_o, rays_d, t_lo, t_hi)
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    # the sample offsets as the plain version computes them, so that both
    # place every sample at the same float32 value
    rel = _sample_offsets(n_samples, rays_o.device)
    t_first = torch.empty(r, dtype=torch.float32, device=rays_o.device)
    hit = torch.empty(r, dtype=torch.bool, device=rays_o.device)
    err = kernels().nw_sampled_hit(
        grid.occ.data_ptr(), level, rays_o.data_ptr(), rays_d.data_ptr(), t_lo.data_ptr(),
        t_hi.data_ptr(), rel.data_ptr(), int(n_samples), r, t_first.data_ptr(), hit.data_ptr(),
        None if steps_out is None else steps_out.data_ptr(), stream_handle(rays_o.device))
    check("nw_sampled_hit", err)
    sampled_first_hit.launches += 1
    return t_first, hit


sampled_first_hit.launches = 0


def _sample_offsets(n_samples: int, device) -> torch.Tensor:
    return (torch.arange(n_samples, dtype=torch.float32, device=device) + 0.5) / n_samples


def sampled_first_hit_plain(grid: DeviceGrid, level: int, rays_o, rays_d, t_lo, t_hi,
                            n_samples: int = 1024, touched: torch.Tensor | None = None,
                            steps_out: torch.Tensor | None = None):
    """The plain PyTorch version of K11 (same contract as
    sampled_first_hit), over the whole (R, n_samples, 3) sample buffer.
    ``touched`` (grid.occ's shape, int32) gains one at a word for every
    sample that tests it: one a sample inside the cube, up to and
    including a ray's first hit. ``steps_out`` ((R,) int32) receives the
    samples walked a ray."""
    rel = _sample_offsets(n_samples, rays_o.device)
    t = t_lo[:, None] + (t_hi - t_lo)[:, None] * rel[None, :]  # (R, K)
    p = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    inside = torch.amax(torch.abs(p), dim=-1) < 1.0
    cells = _cell_index(level, p)
    occ = _bit(grid.occ, cells) & inside
    hit = torch.any(occ, dim=1)
    idx = torch.argmax(occ.to(torch.uint8), dim=1)
    if steps_out is not None:
        steps_out.copy_(torch.where(hit, idx + 1, n_samples))
    if touched is not None:
        end = torch.where(hit, idx, n_samples - 1)
        walked = torch.arange(n_samples, device=rays_o.device)[None, :] <= end[:, None]
        touched.index_add_(0, (cells >> 5).reshape(-1),
                           (walked & inside).reshape(-1).to(torch.int32))
    t_first = torch.gather(t, 1, idx[:, None])[:, 0]
    return torch.where(hit, t_first, torch.zeros_like(t_first)), hit


def grid_near_far(grid, level: int, rays_o_sfm, rays_d, first_only: bool = False):
    """near / far from voxel intersection, SFM units (far is the ENTRY of
    the last voxel: callers add voxel_size), over a DeviceGrid or a
    HierGrid."""
    o_norm = (rays_o_sfm - grid.origin) / grid.scale
    t_first, t_last, hit = traverse(grid, level, o_norm, rays_d, first_only)
    valid = hit & (t_first > 1e-4)
    zero = torch.zeros_like(t_first)
    near = torch.where(valid, t_first * grid.scale, zero)
    far = torch.where(valid, t_last * grid.scale, zero)
    return near, far, valid


# ------------------------------ two-level grid ------------------------------


class HierGrid(NamedTuple):
    """Two-level occupancy on the device (``ray_voxel.py:145-161``): a dense
    bitfield of 8^3-cell blocks at level L - 3 with, per word, the rank of
    its first block among the occupied ones, and 512 fine bits for each
    occupied block in rank order."""

    meta: torch.Tensor  # (2^{3(L-3)}/32, 2) int32: [coarse word, rank base], the uint32 bits
    fine: torch.Tensor  # (16 * n_blocks,) int32: the uint32 words
    origin: torch.Tensor  # (3,) float32, cube center in SFM coords
    scale: float  # cube half-extent (float32 value)
    voxel_size: float  # FINE cell edge in SFM units (float32 value)


# grids at and above this level ship as two-level grids by default
HIER_LEVEL_DEFAULT = 9


def hier_grid_from_host(grid: VoxelGrid, device=None) -> HierGrid:
    """The two-level grid of a host grid (``ray_voxel.py:164-195``), on
    ``device`` (default: the card); meta and fine equal JAX's bit for bit."""
    if grid.level < 3:
        raise ValueError("a two-level grid needs level >= 3")
    device = default_device(device)
    n_c = 1 << (grid.level - 3)
    coords = np.asarray(grid.coords, np.int64).reshape(-1, 3)
    blocks = coords >> 3
    bidx = (blocks[:, 0] * n_c + blocks[:, 1]) * n_c + blocks[:, 2]
    cwords = np.zeros((max(n_c * n_c * n_c // 32, 1),), np.uint32)
    np.bitwise_or.at(cwords, bidx >> 5, np.uint32(1) << (bidx & 31).astype(np.uint32))
    # exclusive prefix of the words' popcounts: a block's slot is
    # rank[word] + popcount(word & ((1 << bit) - 1))
    pc = np.unpackbits(cwords.view(np.uint8)).reshape(-1, 32).sum(axis=1)
    rank = np.zeros(len(pc), np.uint32)
    np.cumsum(pc[:-1], out=rank[1:])
    meta = np.stack([cwords, rank], axis=1)
    ub, inverse = np.unique(bidx, return_inverse=True)  # ascending = slot order
    fine = np.zeros((max(len(ub), 1), 16), np.uint32)
    f = coords & 7
    fidx = (f[:, 0] * 8 + f[:, 1]) * 8 + f[:, 2]
    np.bitwise_or.at(fine, (inverse.reshape(-1), fidx >> 5),
                     np.uint32(1) << (fidx & 31).astype(np.uint32))
    return HierGrid(
        meta=torch.from_numpy(meta.view(np.int32)).to(device),
        fine=torch.from_numpy(fine.reshape(-1).view(np.int32)).to(device),
        origin=torch.as_tensor(np.asarray(grid.origin, np.float32), device=device),
        scale=float(np.float32(grid.scale)),
        voxel_size=float(np.float32(grid.voxel_size)),
    )


def make_device_grid(grid: VoxelGrid, hierarchical: bool | None = None, device=None):
    """A host grid on the device, flat below ``HIER_LEVEL_DEFAULT`` and two-level
    from it up unless ``hierarchical`` says (``ray_voxel.py:365-371``)."""
    if hierarchical is None:
        hierarchical = grid.level >= HIER_LEVEL_DEFAULT
    return (hier_grid_from_host(grid, device) if hierarchical
            else device_grid_from_host(grid, device))


def traverse(grid, level: int, rays_o, rays_d, first_only: bool = False,
             max_steps: int | None = None):
    """The DDA over either grid layout (``ray_voxel.py:374-378``)."""
    if isinstance(grid, HierGrid):
        return dda_traverse_hier(grid, level, rays_o, rays_d, first_only, max_steps)
    return dda_traverse(grid.occ, level, rays_o, rays_d, first_only, max_steps)


def _hier_eps(level: int) -> float:
    """The probe nudge's numerator, w_f * 1e-3, as the float32 both versions use."""
    return float(np.float32(2.0 / (1 << level) * 1e-3))


def dda_traverse_hier(hg: HierGrid, level: int, rays_o: torch.Tensor, rays_d: torch.Tensor,
                      first_only: bool = False, max_steps: int | None = None,
                      steps_out: torch.Tensor | None = None):
    """March rays (R, 3) in grid-normalized coordinates through a two-level
    grid (same contract as dda_traverse). CPU tensors take the plain
    version; CUDA tensors launch K12 (after its mask's pre-pass from
    HIER_MASK_FROM up, which the count leaves out), or raise. ``steps_out``
    ((R,) int32 on the rays' device) receives each ray's steps."""
    if max_steps is None:
        max_steps = _default_steps(level)
    r = rays_o.shape[0]
    if steps_out is not None and (steps_out.shape != (r,) or steps_out.dtype != torch.int32
                                  or steps_out.device != rays_o.device):
        raise ValueError("dda_traverse_hier: steps_out must be (R,) int32 on the rays' device")
    if rays_o.device.type == "cpu":
        return dda_traverse_hier_plain(hg, level, rays_o, rays_d, first_only, max_steps,
                                       steps_out=steps_out)
    if rays_o.device.type != "cuda":
        raise ValueError(f"tensors on {rays_o.device}")
    _check_hier("dda_traverse_hier", hg, level, rays_o, rays_d)
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    t_first = torch.empty(r, dtype=torch.float32, device=rays_o.device)
    t_last = torch.empty_like(t_first)
    hit = torch.empty(r, dtype=torch.bool, device=rays_o.device)
    mask = torch.empty(_MASK_WORDS, dtype=torch.int32, device=rays_o.device)  # the pre-pass's
    err = kernels().nw_dda_hier(
        hg.meta.data_ptr(), mask.data_ptr(), hg.fine.data_ptr(), hg.fine.shape[0], level,
        rays_o.data_ptr(),
        rays_d.data_ptr(), r, int(first_only), int(max_steps), _hier_eps(level),
        t_first.data_ptr(), t_last.data_ptr(), hit.data_ptr(),
        None if steps_out is None else steps_out.data_ptr(), stream_handle(rays_o.device))
    check("nw_dda_hier", err)
    dda_traverse_hier.launches += 1
    return t_first, t_last, hit


dda_traverse_hier.launches = 0


def hier_mask(hg: HierGrid, level: int) -> torch.Tensor:
    """K12's coarse mask of a level-``level`` two-level grid: K10's mask of
    its blocks' bitfield (meta's coarse words, a level-(level - 3) grid),
    ``coarse_words_plain`` at ``mask_shift(level - 3)``. Above MASK_LEVEL + 3
    on a CUDA grid K12's pre-pass (csrc/ray_voxel.cu ``coarse_kernel`` over
    meta's rows), which ``dda_traverse_hier`` runs before every launch from
    HIER_MASK_FROM up; at MASK_LEVEL + 3 and below meta's coarse words
    themselves. CPU tensors take the plain version."""
    if level < 3:
        raise ValueError("a two-level grid needs level >= 3")
    if hg.meta.device.type == "cpu":
        return coarse_words_plain(hg.meta[:, 0].contiguous(), level - 3, mask_shift(level - 3))
    if hg.meta.device.type != "cuda":
        raise ValueError(f"tensors on {hg.meta.device}")
    n_words = max((1 << (3 * (level - 3))) // 32, 1)
    if hg.meta.dtype != torch.int32 or hg.meta.shape != (n_words, 2) \
            or not hg.meta.is_contiguous():
        raise ValueError(f"hier_mask: a level-{level} two-level grid's meta is ({n_words}, 2) "
                         "int32 words")
    if level - 3 <= MASK_LEVEL:
        return hg.meta[:, 0].contiguous()
    mask = torch.empty(_MASK_WORDS, dtype=torch.int32, device=hg.meta.device)
    check("nw_hier_mask", kernels().nw_hier_mask(hg.meta.data_ptr(), level, mask.data_ptr(),
                                                 stream_handle(hg.meta.device)))
    return mask


def _check_hier(name: str, hg: HierGrid, level: int, rays_o, rays_d):
    r = rays_o.shape[0]
    if any(t.dtype != torch.float32 or t.device != rays_o.device for t in (rays_o, rays_d)) \
            or rays_o.shape != (r, 3) or rays_d.shape != (r, 3):
        raise ValueError(f"{name} takes (R, 3) float32 rays on one device")
    n_words = max((1 << (3 * (level - 3))) // 32, 1) if level >= 3 else -1
    if hg.meta.dtype != torch.int32 or hg.meta.shape != (n_words, 2) \
            or hg.fine.dtype != torch.int32 or hg.fine.dim() != 1 \
            or hg.fine.shape[0] % 16 or hg.fine.shape[0] < 16 \
            or not (hg.meta.is_contiguous() and hg.fine.is_contiguous()) \
            or hg.meta.device != rays_o.device or hg.fine.device != rays_o.device:
        raise ValueError(f"{name}: a level-{level} two-level grid is meta ({n_words}, 2) and "
                         "fine (16 n,) int32 words on the rays' device")
    if hg.fine.data_ptr() % 16:  # K12 reads a block's 16 words as four 16-byte loads
        raise ValueError(f"{name}: fine must start on a 16-byte boundary")


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def dda_traverse_hier_plain(hg: HierGrid, level: int, rays_o: torch.Tensor,
                            rays_d: torch.Tensor, first_only: bool = False,
                            max_steps: int | None = None, touched=None, global_reads=None,
                            steps_out=None):
    """The plain PyTorch version of K12 (same contract as dda_traverse;
    ``ray_voxel.py:198-295``). Each step probes the point eps past the
    current entry, reads its block's meta row and its fine bit, and
    advances to the exit of the fine cell inside an occupied block or of
    the whole block through an empty one, recomputed from the cell. The
    f32 arithmetic is the JAX loop's. ``touched`` (a pair of int32 tensors of
    meta's rows and of fine's shape) gains one at a meta row for every step
    of an active ray, and at a fine word for every such step inside an
    occupied block: the words a march reads at least once. ``global_reads``
    ((R,) int32) receives each ray's reads from device memory that K12
    waits on: the meta row of each step outside the block it holds (from
    HIER_MASK_FROM up only in an occupied mask block), and the 16 fine
    words of each occupied block it enters. ``steps_out`` ((R,) int32)
    receives each ray's steps, K12's ``steps_out``."""
    n_f = 1 << level
    n_c = n_f >> 3
    if max_steps is None:
        max_steps = _default_steps(level)
    r = rays_o.shape[0]
    dev = rays_o.device
    w_f, w_c = 2.0 / n_f, 2.0 / n_c
    n_fine = hg.fine.shape[0]

    d = torch.where(torch.abs(rays_d) < 1e-12, torch.full_like(rays_d, 1e-12), rays_d)
    inv_d = 1.0 / d
    t0 = (-1.0 - rays_o) * inv_d
    t1 = (1.0 - rays_o) * inv_d
    t_enter = torch.clamp(torch.amax(torch.minimum(t0, t1), dim=-1), min=0.0)
    t_leave = torch.amin(torch.maximum(t0, t1), dim=-1)
    active = t_leave > t_enter
    d_max = torch.amax(torch.abs(d), dim=-1)
    eps_t = torch.full_like(d_max, _hier_eps(level)) / d_max
    step_dir = (d > 0).to(torch.float32)
    words = hg.meta[:, 0].to(torch.int64) & 0xFFFFFFFF
    ranks = hg.meta[:, 1].to(torch.int64)
    if steps_out is not None:
        steps_out.zero_()
    if global_reads is not None:
        global_reads.zero_()
        mask = None
        if level >= HIER_MASK_FROM:  # K12's mask, its plain version
            mask = coarse_words_plain(hg.meta[:, 0].contiguous(), level - 3,
                                      mask_shift(level - 3)).to(torch.int64) & 0xFFFFFFFF
        held_b = torch.full((r,), -1, dtype=torch.int64, device=dev)

    t_cur = t_enter
    first = torch.full((r,), _INF, device=dev)
    last = torch.full((r,), -_INF, device=dev)
    for i in range(max_steps):
        if i % _SYNC_EVERY == 0 and not bool(active.any()):
            break
        tt = t_cur + eps_t
        p = rays_o + d * tt[:, None]
        c = torch.clamp(torch.floor((p + 1.0) / w_f), 0, n_f - 1).to(torch.int64)
        b = c >> 3
        bidx = (b[:, 0] * n_c + b[:, 1]) * n_c + b[:, 2]
        row = bidx >> 5
        word, bit = words[row], bidx & 31
        blk = ((word >> bit) & 1) == 1
        slot = ranks[row] + _popcount32(word & ((1 << bit) - 1))
        f = c & 7
        fidx = (f[:, 0] * 8 + f[:, 1]) * 8 + f[:, 2]
        at = torch.clamp(slot * 16 + (fidx >> 5), 0, n_fine - 1)
        occ_hit = blk & (((hg.fine[at] >> (fidx & 31)) & 1) == 1) & active
        if touched is not None:
            touched[0].index_add_(0, row, active.to(torch.int32))
            touched[1].index_add_(0, at, (active & blk).to(torch.int32))
        if steps_out is not None:
            steps_out += active.to(torch.int32)
        if global_reads is not None:
            new_b = active & (bidx != held_b)
            if mask is not None:
                m = c >> (level - MASK_LEVEL)
                m = (m[:, 0] << (2 * MASK_LEVEL)) | (m[:, 1] << MASK_LEVEL) | m[:, 2]
                new_b = new_b & (((mask[m >> 5] >> (m & 31)) & 1) == 1)
            entered = new_b & blk
            global_reads += new_b.to(torch.int32) + entered.to(torch.int32)
            held_b = torch.where(entered, bidx, held_b)
        first = torch.where(occ_hit & (first >= _INF), t_cur, first)
        last = torch.where(occ_hit, t_cur, last)

        use_fine = blk[:, None]
        cell_g = torch.where(use_fine, c, b).to(torch.float32)
        w_g = torch.where(use_fine, w_f, w_c)
        hi = (cell_g + step_dir) * w_g - 1.0
        t_ex = torch.amin((hi - rays_o) * inv_d, dim=-1)
        t_next = torch.maximum(t_ex, tt)  # at least eps of progress
        active = active & (t_next < t_leave)
        if first_only:
            active = active & (first >= _INF)
        t_cur = t_next
    hit = first < _INF
    zero = torch.zeros_like(first)
    return torch.where(hit, first, zero), torch.where(hit, last, zero), hit
