"""K15 (``csrc/split_tf32_gemm.cu``): float32 products on the tensor cores
at float32 accuracy, with the plain PyTorch version of the same arithmetic
and the autograd Function that the field's float32 linears run through
(``models/layers._product``).

Each float32 operand is split into two TF32 values, x = hi + lo, hi = x
rounded to TF32 (``cvt.rna``: to nearest, ties away from zero, the low 13
mantissa bits cleared), lo = x - hi rounded the same way; a product is
a_lo b_hi + a_hi b_lo + a_hi b_hi, summed in float32 (a_lo b_lo, ~2^-22 of
the product, is dropped). A TF32 product alone rounds each operand to 11
bits, ~2^-11 of the product; the split keeps ~22 bits, and float32 keeps
24.

``split_tf32_gemm(a, b, form, bias)`` computes one of three forms over
row-major operands: 'nt' a b^T (+ bias), 'nn' a b, 'tn' a^T b. Their
gradients are products of the same forms, so ``SplitTF32Product``'s
backward applies itself and the double backward (the eikonal term's) runs
on K15 too. CPU tensors take the plain version; CUDA tensors launch K15 (or
raise). In float64 the plain version does not round (hi = x, lo = 0): the
Function's derivatives can then be checked against ``F.linear``'s."""

from __future__ import annotations

import torch

from .build import check, kernels, stream_handle

FORMS = {"nt": 0, "nn": 1, "tn": 2}
BM, BK = 128, 32  # csrc/split_tf32_gemm.cu: rows of a block's tile, k a stage
WIDTHS = tuple(range(8, 137, 8))  # a tile's columns (wgmma n), the kernel's instances
TILE_COST = 32  # columns' worth of work a tile costs besides its own (its A's loads and split)
SMS = 132  # the H100 SXM's SMs: a 'tn' product's slices give each a block
MIN_SLICE = 8  # stages of 32 rows a 'tn' slice reduces at least


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 as ``cvt.rna.tf32.f32``: half of the
    13 dropped bits' range added to the magnitude, then those bits cleared."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32).view(t.shape)


def tf32_split(t: torch.Tensor):
    """(hi, lo): two TF32 values with hi + lo within 2^-22 |t| of float32
    ``t``; another dtype is not rounded (``t``, 0)."""
    if t.dtype != torch.float32:
        return t, torch.zeros_like(t)
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def _mm(a, b, form):
    return a @ b.t() if form == "nt" else a @ b if form == "nn" else a.t() @ b


def split_tf32_gemm_plain(a, b, form: str, bias=None):
    """The plain version of K15: the three TF32 products in float32, small
    ones first."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    c = _mm(a_lo, b_hi, form) + _mm(a_hi, b_lo, form) + _mm(a_hi, b_hi, form)
    return c if bias is None else c + bias


def gemm_dims(a, b, form: str) -> tuple:
    """(m, n, k) of the form's product; raises on shapes that do not meet."""
    if form not in FORMS or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"a product '{form}' of {tuple(a.shape)} and {tuple(b.shape)}")
    (m, k), (n, k2) = (a.shape if form != "tn" else a.shape[::-1],
                       b.shape if form == "nt" else b.shape[::-1])
    if k != k2:
        raise ValueError(f"a product '{form}' of {tuple(a.shape)} and {tuple(b.shape)}")
    return m, n, k


def tile_width(n: int) -> int:
    """The tile width for n columns: the fewest columns computed, each tile
    charged ``TILE_COST`` more; the wider of a tie."""
    return min(reversed(WIDTHS), key=lambda w: -(-n // w) * (w + TILE_COST))


def tile_cost(m: int, n: int) -> int:
    """The columns' worth of work of C (m, n)'s tiles, as ``tile_width``
    counts it."""
    w = tile_width(n)
    return -(-m // BM) * -(-n // w) * (w + TILE_COST)


def slices_for(tiles: int, k: int) -> tuple:
    """('tn') (slices, stages a slice): enough slices to give the SMs a
    block each, none of fewer than ``MIN_SLICE`` stages."""
    stages = -(-k // BK)
    want = max(1, min(SMS // tiles, stages // MIN_SLICE))
    per = -(-stages // want)
    return -(-stages // per), per


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as K15 reads it: unit column stride, rows 16 bytes apart and
    at a 16-byte base; otherwise copied into such a buffer."""
    rows, cols = t.shape
    if t.stride(1) == 1 and t.stride(0) % 4 == 0 and t.stride(0) >= cols and t.data_ptr() % 16 == 0:
        return t
    buf = t.new_empty(rows, -(-cols // 4) * 4)
    buf[:, :cols] = t
    return buf[:, :cols]


def split_tf32_gemm(a: torch.Tensor, b: torch.Tensor, form: str, bias=None) -> torch.Tensor:
    """The product ``form`` of a and b (+ bias, 'nt' only); CPU tensors take
    the plain version, float32 CUDA tensors launch K15 (or raise), counted
    in ``launches``."""
    m, n, k = gemm_dims(a, b, form)
    if bias is not None and (form != "nt" or bias.shape != (n,)):
        raise ValueError(f"a bias of {tuple(bias.shape)} for a product '{form}' of {n} columns")
    if a.device.type == "cpu":
        return split_tf32_gemm_plain(a, b, form, bias)
    if a.dtype != torch.float32 or b.dtype != torch.float32 or b.device != a.device or (
            bias is not None and (bias.dtype != torch.float32 or bias.device != a.device)):
        raise ValueError(f"K15 takes float32 operands on one device, got {a.dtype} on {a.device},"
                         f" {b.dtype} on {b.device}")
    if m == 0 or n == 0 or k == 0:
        c = a.new_zeros(m, n)
        return c if bias is None else c + bias
    if form == "tn" and tile_cost(n, m) < tile_cost(m, n):
        # a weight gradient of few rows (the sdf row's 4) on tiles of 128
        # rows: C^T = b^T a, transposed back (C is the size of a weight)
        return split_tf32_gemm(b, a, "tn").t().contiguous()
    a, b = _operand(a), _operand(b)
    bias = None if bias is None else bias.contiguous()
    bn = tile_width(n)
    slices, per = (slices_for(-(-n // bn) * -(-m // BM), k) if form == "tn"
                   else (1, -(-k // BK)))
    c = a.new_empty(m, n)
    parts = a.new_empty(slices, m, n) if slices > 1 else None
    err = kernels().nw_split_tf32_gemm(
        FORMS[form], a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        None if bias is None else bias.data_ptr(), m, n, k, bn, slices, per,
        None if parts is None else parts.data_ptr(), c.data_ptr(), stream_handle(a.device))
    check("nw_split_tf32_gemm", err)
    split_tf32_gemm.launches += 1
    return c


split_tf32_gemm.launches = 0


class SplitTF32Product(torch.autograd.Function):
    """``split_tf32_gemm`` with its gradients, each a product of the three
    forms (so it has a double backward), the bias's gradient the
    cotangent's column sum; its forward-mode derivative and a batching rule
    let ``torch.func``'s ``jvp`` and ``vmap`` run it (the 'fwd' SDF mode)."""

    @staticmethod
    def forward(a, b, bias, form):
        return split_tf32_gemm(a, b, form, bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, _, form = inputs
        ctx.save_for_backward(a, b)
        ctx.save_for_forward(a, b)
        ctx.form = form

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        need_a, need_b, need_bias = ctx.needs_input_grad[:3]
        product = SplitTF32Product.apply
        ga = gb = None
        if ctx.form == "nt":  # c = a b^T
            ga = product(g, b, None, "nn") if need_a else None
            gb = product(g, a, None, "tn") if need_b else None
        elif ctx.form == "nn":  # c = a b
            ga = product(g, b, None, "nt") if need_a else None
            gb = product(a, g, None, "tn") if need_b else None
        else:  # c = a^T b
            ga = product(b, g, None, "nt") if need_a else None
            gb = product(a, g, None, "nn") if need_b else None
        return ga, gb, g.sum(0) if need_bias else None, None

    @staticmethod
    def jvp(ctx, a_t, b_t, bias_t, _):
        """The product is bilinear: d(a b) = da b + a db (+ dbias)."""
        a, b = ctx.saved_tensors
        m, n, _ = gemm_dims(a, b, ctx.form)
        out = a.new_zeros(m, n) if bias_t is None else bias_t.expand(m, n)
        if a_t is not None:
            out = out + SplitTF32Product.apply(a_t, b, None, ctx.form)
        if b_t is not None:
            out = out + SplitTF32Product.apply(a, b_t, None, ctx.form)
        return out

    @staticmethod
    def vmap(info, in_dims, a, b, bias, form):
        """A batch of a alone in 'nt' / 'nn' is one product over its rows;
        any other batch, one product an entry."""
        da, db, dbias, _ = in_dims
        if db is None and dbias is None and form != "tn":
            a = a.movedim(da, 0)
            c = SplitTF32Product.apply(a.reshape(-1, a.shape[-1]), b, bias, form)
            return c.reshape(a.shape[0], -1, c.shape[-1]), 0

        def entry(t, d, i):
            return t if d is None else t.select(d, i)

        return torch.stack([SplitTF32Product.apply(entry(a, da, i), entry(b, db, i),
                                                   entry(bias, dbias, i), form)
                            for i in range(info.batch_size)]), 0


def split_tf32_linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """``F.linear(x, w, b)`` through ``SplitTF32Product``."""
    y = SplitTF32Product.apply(x.reshape(-1, x.shape[-1]), w, b, "nt")
    return y.reshape(*x.shape[:-1], w.shape[0])
