"""The benchmark's synthetic scene, made from the seed on the run's device:
SFM points on a sphere, the SFM occupancy grid over them, a level-L fine
grid that is a shell around the sphere, ring cameras' training rays with
their colours, labels and SFM depth, and served frames.

Frozen, adapted copies of ``chip_smoke.py``'s ``sphere_points``,
``camera_rays``, ``training_rays``, ``shell_coords`` and ``make_scene``
(and of ``ops/voxel_grid.grid_from_points``' quantisation): written in torch
so that 30 million rays are made on the card in a second, and kept here so
that no edit to chip_smoke or the port moves what the benchmark runs. The
shell is tested cell by cell (centre within half_cells cells of the sphere)
instead of column by column; the grids are packed into the port's
occupancy words, bit (x * N + y) * N + z of a level-L grid of N = 2^L."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# semantic ids of the port's label table (datasets/mask_utils.py)
LABEL_BUILDING, LABEL_SKY, LABEL_PERSON = 1, 2, 12
SURFACE_RGB = (0.8, 0.6, 0.4)
SKY_RGB = (0.55, 0.7, 0.95)
LIGHT = (0.3, -0.5, 0.8)


class Grid(NamedTuple):
    """An occupancy grid over the cube [-scale, scale]^3 about ``origin``."""

    occ: torch.Tensor  # (2^{3L} / 32,) int32 words
    origin: torch.Tensor  # (3,) float32
    scale: float
    voxel_size: float
    level: int


def pack_bits(cells: torch.Tensor) -> torch.Tensor:
    """A flat bool tensor of cells (length a multiple of 32) as int32 words,
    bit i of word w holding cell 32 w + i."""
    bits = cells.reshape(-1, 32).to(torch.int64)
    words = (bits << torch.arange(32, device=cells.device)).sum(1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def sphere_points(n: int, radius: float, gen: torch.Generator) -> torch.Tensor:
    """(n, 3) float64 points on |x| = radius: the scene's SFM keypoints."""
    v = torch.randn(n, 3, generator=gen, dtype=torch.float64, device=gen.device)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True) * radius


def sfm_grid(points: torch.Tensor, half: float, voxel: float) -> Grid:
    """The expand-1 SFM grid of ``grid_from_points`` over the cube of half
    extent ``half`` about the origin: each point moved by each of the 27
    offsets of one voxel, quantised at level floor(log2(2 half / voxel))."""
    level = int(math.floor(math.log2(2.0 * half / voxel)))
    res = 1 << level
    cells = torch.zeros(res ** 3, dtype=torch.bool, device=points.device)
    r = torch.arange(-1, 2, device=points.device, dtype=torch.float64)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3) * voxel
    for off in offs:
        u = (points + off) / (2.0 * half) + 0.5
        u = u[torch.all((u > 0.0) & (u < 1.0), dim=-1)]
        c = torch.clamp((u * res).long(), max=res - 1)
        cells[(c[:, 0] * res + c[:, 1]) * res + c[:, 2]] = True
    return Grid(pack_bits(cells), torch.zeros(3, dtype=torch.float32, device=points.device),
                _f32(half), _f32(2.0 * half / res), level)


def shell_grid(level: int, half: float, radius: float, half_cells: float, device) -> Grid:
    """The level-``level`` grid over [-half, half]^3 whose cells have their
    centre within half_cells cells of the sphere |x| = radius; built a slab
    of x at a time, so no dense 2^{3L} tensor is made."""
    n = 1 << level
    cw = 2.0 * half / n
    c = (torch.arange(n, device=device, dtype=torch.float64) + 0.5) * cw - half
    r_in2, r_out2 = (radius - half_cells * cw) ** 2, (radius + half_cells * cw) ** 2
    yz = c[:, None] ** 2 + c[None, :] ** 2
    slab = max(1, (1 << 22) // (n * n))
    words = []
    for x0 in range(0, n, slab):
        r2 = c[x0:x0 + slab, None, None] ** 2 + yz[None]
        words.append(pack_bits(((r2 >= r_in2) & (r2 <= r_out2)).reshape(-1)))
    return Grid(torch.cat(words), torch.zeros(3, dtype=torch.float32, device=device), _f32(half),
                _f32(cw), level)


def camera_rays(wh, focal: float, eye: torch.Tensor):
    """(H*W, 3) float64 origins and unit directions of a pinhole camera at
    ``eye`` looking at the origin, z up (x right, y up, looking down -z; no
    half-pixel offset)."""
    w, h = wh
    dev = eye.device
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                          torch.arange(w, dtype=torch.float64, device=dev), indexing="ij")
    dirs = torch.stack([(i - w / 2) / focal, -(j - h / 2) / focal, -torch.ones_like(i)], -1)
    back = eye / torch.linalg.vector_norm(eye)
    right = torch.linalg.cross(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=dev),
                               back)
    right = right / torch.linalg.vector_norm(right)
    up = torch.linalg.cross(back, right)
    d = dirs.reshape(-1, 3) @ torch.stack([right, up, back], dim=1).T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return eye.expand(d.shape), d


def _uniform(gen, lo, hi):
    return lo + (hi - lo) * float(torch.rand((), generator=gen, dtype=torch.float64,
                                             device=gen.device))


def training_rows(n_cams: int, wh, cam_dist: float, gen: torch.Generator):
    """Ray-cache rows (N, 12) float32 [o, d, near, far, ts, label, depth,
    weight] and colours (N, 3) float32 from ``n_cams`` ring cameras around
    the unit sphere, on the generator's device. near / far bound each ray's
    chord of the training sphere |x| = 2; the colour is a Lambertian shading
    of the sphere, the sky behind it; labels 'sky' where a ray misses,
    'person' on the lower cap, 'building' elsewhere; every fourth ray that
    hits carries its SFM depth with weight 1; ts is the camera's index."""
    dev = gen.device
    n = wh[0] * wh[1]
    rows = torch.empty(n_cams * n, 12, dtype=torch.float32, device=dev)
    rgbs = torch.empty(n_cams * n, 3, dtype=torch.float32, device=dev)
    light = torch.tensor(LIGHT, dtype=torch.float64, device=dev)
    light = light / torch.linalg.vector_norm(light)
    surface = torch.tensor(SURFACE_RGB, dtype=torch.float64, device=dev)
    sky = torch.tensor(SKY_RGB, dtype=torch.float64, device=dev)
    every4 = (torch.arange(n, device=dev) % 4) == 0
    for cam in range(n_cams):
        ang = 2 * math.pi * cam / n_cams + _uniform(gen, 0.0, 0.1)
        z = 0.6 + _uniform(gen, -0.2, 0.2)
        eye = torch.tensor([cam_dist * math.cos(ang), cam_dist * math.sin(ang), z],
                           dtype=torch.float64, device=dev)
        o, d = camera_rays(wh, 1.2 * wh[0], eye)
        b = (o * d).sum(-1)
        c2 = (o * o).sum(-1)
        chord = torch.sqrt(torch.clamp(b * b - c2 + 4.0, min=0.0))
        disc = b * b - c2 + 1.0
        hit = disc > 0
        t_hit = torch.where(hit, -b - torch.sqrt(torch.clamp(disc, min=0.0)),
                            torch.zeros_like(b))
        p = o + d * t_hit[:, None]
        shade = 0.15 + 0.85 * torch.clamp(p @ light, min=0.0)
        rgb = torch.where(hit[:, None], surface * shade[:, None], sky)
        label = torch.where(hit, torch.where(p[:, 2] < -0.6, LABEL_PERSON, LABEL_BUILDING),
                            LABEL_SKY)
        sl = slice(cam * n, (cam + 1) * n)
        rows[sl] = torch.cat([o, d, (-b - chord)[:, None], (-b + chord)[:, None],
                              torch.full_like(b, cam)[:, None], label[:, None].double(),
                              t_hit[:, None], (hit & every4).double()[:, None]], 1).float()
        rgbs[sl] = rgb.float()
    return rows, rgbs


def serve_frames(n_frames: int, wh, cam_dist: float, n_vocab: int, gen: torch.Generator):
    """``n_frames`` served views of the sphere from seeded ring poses: per
    frame (H*W, 10) float32 rays [o, d, near 0.5, far 6, 0, 0] in SFM units
    and its appearance id."""
    dev = gen.device
    frames = []
    for f in range(n_frames):
        ang = 2 * math.pi * f / n_frames + _uniform(gen, 0.0, 0.1)
        eye = torch.tensor([cam_dist * math.cos(ang), cam_dist * math.sin(ang), 0.6],
                           dtype=torch.float64, device=dev)
        o, d = camera_rays(wh, 1.2 * wh[0], eye)
        n = len(o)
        rays = torch.cat([o, d, torch.full((n, 1), 0.5, dtype=torch.float64, device=dev),
                          torch.full((n, 1), 6.0, dtype=torch.float64, device=dev),
                          torch.zeros((n, 2), dtype=torch.float64, device=dev)], 1).float()
        a_id = int(torch.randint(0, n_vocab, (), generator=gen, device=dev))
        frames.append((rays, a_id))
    return frames
