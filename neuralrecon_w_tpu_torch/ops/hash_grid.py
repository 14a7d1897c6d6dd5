"""The multi-resolution hash encoding (Instant-NGP, Mueller et al. 2022, as
Neuralangelo configures it): K13 (``csrc/hash_grid.cu``
``hash_encode_kernel``), the gather and trilinear blend, and K14
(``hash_grad_kernel``), the table's gradient by scatter-add, with the plain
PyTorch version of each.

Level l of L has resolution N_l = floor(N_min b^l), b = exp((ln N_max -
ln N_min) / (L - 1)). A point x, clamped to [-B, B]^3, is scaled to u = (x
+ B) N_l / (2 B) (one float32 add and one float32 product, the scale
N_l / (2 B) rounded once); its cell's corner is c0 = min(floor(u), N_l - 1)
and the eight corners c0 + {0, 1}^3 are blended with the trilinear weights
of t = u - c0 (x's factor, times y's, times z's). A level with (N_l + 1)^3
<= T entries is indexed densely, c_x + c_y (N_l + 1) + c_z (N_l + 1)^2;
the others by the hash (c_x ^ c_y 2654435761 ^ c_z 805459861) mod T in
uint32 arithmetic (T a power of two). Level l's entries follow level l -
1's in one (entries, F) float32 table; the output is (P, L F), level l's
F features at columns l F. Levels at or past ``active`` (a 0-d int32
device tensor, read by the kernels from device memory) give zeros and
take no gradient.

Both kernels run one thread a (point, level) and read the active count on
the device, so one CUDA graph serves every stage of the coarse-to-fine
schedule. K14 adds with float atomics (four floats an instruction on the
card), so its sums equal the plain version's ``index_add_`` only to
rounding. Nothing computes the gradient with respect to the points: the
field's losses reach the table and the MLP only.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..tracing import span
from .build import check, kernels, stream_handle

PRIMES = (1, 2654435761, 805459861)
MAX_LEVELS = 32  # csrc/hash_grid.cu's HASH_MAX_LEVELS


class HashGridSpec(NamedTuple):
    """The static layout of a hash grid."""

    levels: int
    features: int
    table_size: int  # T, entries a hashed level
    bound: float
    res: tuple  # N_l
    scale: tuple  # N_l / (2 B), float32 values
    offsets: tuple  # the first entry of each level
    dense: tuple  # whether each level is indexed densely
    n_entries: int

    @property
    def width(self) -> int:
        return self.levels * self.features


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def level_resolutions(levels: int, min_res: int, max_res: int) -> tuple:
    """N_l = floor(N_min b^l), b = exp((ln N_max - ln N_min) / (L - 1)),
    floored after a 1e-6 nudge so that exact powers stay exact (N_5 = 128,
    N_15 = 2048 at Neuralangelo's 32 to 2048 over 16 levels)."""
    if levels == 1:
        return (int(min_res),)
    b = math.exp((math.log(max_res) - math.log(min_res)) / (levels - 1))
    return tuple(int(math.floor(min_res * b ** l + 1e-6)) for l in range(levels))


def grid_spec(cfg: dict) -> HashGridSpec:
    """The layout of an SDF_CONFIG of type hashgrid."""
    levels, feats = int(cfg["levels"]), int(cfg["features"])
    t = 1 << int(cfg["log2_table"])
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"a hash grid takes 1 to {MAX_LEVELS} levels, not {levels}")
    if feats != 8:
        raise ValueError(f"the hash kernels take 8 features an entry, not {feats}")
    bound = float(cfg["bound"])
    res = level_resolutions(levels, int(cfg["min_res"]), int(cfg["max_res"]))
    offsets, dense, off = [], [], 0
    for n in res:
        d = (n + 1) ** 3 <= t
        offsets.append(off)
        dense.append(d)
        off += (n + 1) ** 3 if d else t
    return HashGridSpec(levels, feats, t, bound, res,
                        tuple(_f32(n / (2.0 * bound)) for n in res), tuple(offsets),
                        tuple(dense), off)


def _level_rows(spec: HashGridSpec, l: int, x: torch.Tensor):
    """The (P, 8) table rows and (P, 8) trilinear weights of level l's
    corners; corner k takes c0 + (k >> 2 & 1, k >> 1 & 1, k & 1)."""
    n = spec.res[l]
    xc = torch.clamp(x.float(), -spec.bound, spec.bound)
    u = (xc + spec.bound) * spec.scale[l]
    c0 = torch.clamp(torch.floor(u), max=n - 1)
    t = u - c0
    c0 = c0.long()
    rows, ws = [], []
    for k in range(8):
        bits = torch.tensor([(k >> 2) & 1, (k >> 1) & 1, k & 1], device=x.device)
        c = c0 + bits
        w3 = torch.where(bits.bool(), t, 1.0 - t)
        ws.append(w3[:, 0] * w3[:, 1] * w3[:, 2])
        if spec.dense[l]:
            idx = c[:, 0] + c[:, 1] * (n + 1) + c[:, 2] * (n + 1) ** 2
        else:
            idx = ((c[:, 0] * PRIMES[0]) ^ (c[:, 1] * PRIMES[1]) ^ (c[:, 2] * PRIMES[2])) & (
                spec.table_size - 1)
        rows.append(idx + spec.offsets[l])
    return torch.stack(rows, 1), torch.stack(ws, 1)


def hash_encode_plain(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                      active: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K13: (P, 3) points -> (P, L F)."""
    outs = []
    for l in range(spec.levels):
        rows, w = _level_rows(spec, l, x)
        f = (table[rows] * w[..., None].to(table.dtype)).sum(1)
        outs.append(f * (active > l).to(table.dtype))
    return torch.cat(outs, -1)


def hash_grad_plain(x: torch.Tensor, grad_out: torch.Tensor, spec: HashGridSpec,
                    active: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K14: the table's gradient (entries, F)
    from the encoding's (P, L F)."""
    g = torch.zeros(spec.n_entries, spec.features, dtype=grad_out.dtype, device=grad_out.device)
    for l in range(spec.levels):
        rows, w = _level_rows(spec, l, x)
        gl = grad_out[:, l * spec.features:(l + 1) * spec.features] * (active > l).to(g.dtype)
        g.index_add_(0, rows.reshape(-1),
                     (w[..., None] * gl[:, None, :]).reshape(-1, spec.features))
    return g


class _Levels(ctypes.Structure):
    _fields_ = [("res", ctypes.c_int * MAX_LEVELS), ("scale", ctypes.c_float * MAX_LEVELS),
                ("offset", ctypes.c_longlong * MAX_LEVELS), ("dense", ctypes.c_int * MAX_LEVELS),
                ("levels", ctypes.c_int), ("table_mask", ctypes.c_int), ("bound", ctypes.c_float)]


def _levels(spec: HashGridSpec) -> _Levels:
    pad = MAX_LEVELS - spec.levels
    return _Levels((ctypes.c_int * MAX_LEVELS)(*spec.res, *([0] * pad)),
                   (ctypes.c_float * MAX_LEVELS)(*spec.scale, *([0.0] * pad)),
                   (ctypes.c_longlong * MAX_LEVELS)(*spec.offsets, *([0] * pad)),
                   (ctypes.c_int * MAX_LEVELS)(*(int(d) for d in spec.dense), *([0] * pad)),
                   spec.levels, spec.table_size - 1, spec.bound)


def _checked(x, table, active):
    if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"expected (P, 3) float32 points, got {tuple(x.shape)} {x.dtype}")
    if table.dtype != torch.float32 or active.dtype != torch.int32:
        raise ValueError("the hash kernels take a float32 table and an int32 active count")
    if x.device.type != "cuda" or table.device != x.device or active.device != x.device:
        raise ValueError(f"points on {x.device}, table on {table.device}, count on "
                         f"{active.device}")


def hash_encode(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                active: torch.Tensor) -> torch.Tensor:
    """(P, 3) float32 points -> (P, L F) features; CPU tensors take the plain
    version, CUDA tensors launch K13 (or raise), counted in ``launches``
    and, by points, in ``points``."""
    with span("field.hash_encode", x.device):
        if x.device.type == "cpu":
            out = hash_encode_plain(x, table, spec, active)
        else:
            _checked(x, table, active)
            x = x.contiguous()
            out = torch.empty(x.shape[0], spec.width, dtype=torch.float32, device=x.device)
            lv = _levels(spec)
            err = kernels().nw_hash_encode(x.data_ptr(), x.shape[0], table.data_ptr(),
                                           active.data_ptr(), ctypes.addressof(lv),
                                           out.data_ptr(), stream_handle(x.device))
            check("nw_hash_encode", err)
            hash_encode.launches += 1
            hash_encode.points += x.shape[0]
    return out


hash_encode.launches = 0
hash_encode.points = 0  # points K13 encoded (a graph's replays are not counted)


def hash_grad(x: torch.Tensor, grad_out: torch.Tensor, spec: HashGridSpec,
              active: torch.Tensor) -> torch.Tensor:
    """The table's gradient (entries, F) from the encoding's (P, L F); CPU
    tensors take the plain version, CUDA tensors launch K14 (or raise)."""
    with span("field.hash_grad", x.device):
        if x.device.type == "cpu":
            return hash_grad_plain(x, grad_out, spec, active)
        _checked(x, grad_out, active)
        if grad_out.shape != (x.shape[0], spec.width):
            raise ValueError(f"a gradient of {tuple(grad_out.shape)} for {x.shape[0]} points")
        x, grad_out = x.contiguous(), grad_out.contiguous()
        g = torch.zeros(spec.n_entries, spec.features, dtype=torch.float32, device=x.device)
        lv = _levels(spec)
        err = kernels().nw_hash_grad(x.data_ptr(), x.shape[0], grad_out.data_ptr(),
                                     active.data_ptr(), ctypes.addressof(lv), g.data_ptr(),
                                     stream_handle(x.device))
        check("nw_hash_grad", err)
        hash_grad.launches += 1
        return g


hash_grad.launches = 0


class HashEncode(torch.autograd.Function):
    """The encoding with the table's gradient; the points take none."""

    @staticmethod
    def forward(ctx, x, table, spec, active):
        ctx.save_for_backward(x, active)
        ctx.spec = spec
        return hash_encode(x, table, spec, active)

    @staticmethod
    def backward(ctx, grad_out):
        x, active = ctx.saved_tensors
        return None, hash_grad(x, grad_out, ctx.spec, active), None, None


def encode(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
           active: torch.Tensor) -> torch.Tensor:
    """The encoding of (P, 3) points, differentiable in the table where
    autograd records."""
    if torch.is_grad_enabled() and table.requires_grad:
        return HashEncode.apply(x, table, spec, active)
    return hash_encode(x, table, spec, active)
