"""Floating-point operations of the NeuS-W field and the renderer's sample
counts, from a configuration's widths (a ``benchmark/configs`` file).

A linear of (k inputs, n outputs) costs 2 k n operations a row. Counted, a
foreground sample: the SDF net's products (at the published widths 39→512,
512→512 x2, 512→473, 512→512 x4, 512→513: 2,097,664 multiply-adds), the
input-gradient pass (the products back from the SDF column to the
encoding) and the colour head; a background sample the NeRF++ products; a
sampler evaluation the SDF net up to its SDF column. A part the renderer
takes once a ray (the view and appearance blocks of the two heads' first
layers) is counted once a ray. Training adds the backward of each forward
product and of the gradient pass: twice their operations (the weights' and
the inputs' gradients), so three times in all. Recomputed work is not
counted. Elementwise work (encodings, activations, compositing) is left
out: it is not a product and no peak applies to it.

Origin: the work counting of ``chip_smoke.gemm_flops`` (2 k n a row over
each product), extended to the whole field; the shapes follow
``models/sdf.sdf_layer_shapes``, ``models/color.color_dims`` and
``models/nerf_bg.NeRF`` of the port, and the sample counts
``rendering/renderer.bg_eval_idx`` and ``sparse_sampler``."""

from __future__ import annotations

from ..reference.render import bg_eval_idx

NERF_D, NERF_W, NERF_SKIP = 8, 256, 4  # the background NeRF++'s depth, width, skip
NERF_PE, NERF_VIEW_PE = 10, 4


def pe_dim(d_in: int, n_freqs: int) -> int:
    return d_in * (1 + 2 * n_freqs) if n_freqs > 0 else d_in


def sdf_products(sdf: dict) -> list:
    """(k, n) of each of the SDF net's products, the layer before a skip
    shrunk so that the concatenation is d_hidden wide."""
    d_pe = pe_dim(sdf["d_in"], sdf["multires"])
    dims = [d_pe] + [sdf["d_hidden"]] * sdf["n_layers"] + [sdf["d_out"]]
    skip = tuple(sdf["skip_in"])
    return [(dims[l], dims[l + 1] - d_pe if l + 1 in skip else dims[l + 1])
            for l in range(len(dims) - 1)]


def macs(products) -> int:
    return sum(k * n for k, n in products)


def sdf_head_products(sdf: dict) -> list:
    """The products up to the SDF column alone: the sampler's evaluations,
    and (in reverse) the input-gradient pass."""
    p = sdf_products(sdf)
    return p[:-1] + [(p[-1][0], 1)]


def color_products(color: dict, n_a: int, encode_a: bool) -> tuple:
    """(products a sample, products a ray) of the colour head."""
    view = pe_dim(3, color["multires_view"])
    h, f = color["head_channels"], color["d_feature"]
    if encode_a:
        per_sample = [(f, f), (f, h)] + [(h, h)] * (color["static_head_layers"] - 1)
        per_ray = [(view + n_a, h)]
        d0 = color["d_in"] + h - 3
    else:
        per_sample, per_ray = [], []
        d0 = color["d_in"] + f + view - 3
    dims = [d0] + [color["d_hidden"]] * color["n_layers"] + [color["d_out"]]
    per_sample += [(dims[l], dims[l + 1]) for l in range(len(dims) - 1)]
    return per_sample, per_ray


def nerf_products(n_a: int, encode_a_bg: bool) -> tuple:
    """(products a point, products a ray) of the background NeRF++."""
    d_pe, view = pe_dim(4, NERF_PE), pe_dim(3, NERF_VIEW_PE)
    w = NERF_W
    per_point = [(d_pe, w)] + [(w + d_pe if i - 1 == NERF_SKIP else w, w)
                               for i in range(1, NERF_D)]
    per_point += [(w, 1), (w, w)]
    if encode_a_bg:
        per_point += [(w, w // 2)] + [(w // 2, w // 2)] * (NERF_D // 2 - 1)
        per_ray = [(view + n_a, w // 2)]
    else:
        per_point += [(w, w // 2)]
        per_ray = [(view, w // 2)]
    per_point += [(w // 2, 3)]
    return per_point, per_ray


def bg_eval_count(bg_samples: int, n_total: int, n_outside: int) -> int:
    """Background positions the NeRF++ evaluates a ray: a coarse stride of
    ``bg_samples`` plus the n_outside tail, or all of them."""
    idx = bg_eval_idx(bg_samples, n_total, n_outside)
    return n_total if idx is None else len(idx)


def samples_per_ray(cfg: dict, fine_grid: bool = True) -> dict:
    """Per ray: foreground samples, background evaluations and the
    sampler's SDF evaluations, from a configuration file's sections."""
    n, tpu = cfg["NEUCONW"], cfg["TPU"]
    boundary = tpu["BOUNDARY_SAMPLES"] if tpu["BOUNDARY_SAMPLES"] >= 0 else n["BOUNDARY_SAMPLES"]
    fg = n["N_SAMPLES"] + n["N_IMPORTANCE"] + (boundary if fine_grid else 0)
    steps = n["UP_SAMPLE_STEP"]
    sampler = n["N_SAMPLES"] + (steps - 1) * (n["N_IMPORTANCE"] // steps)
    bg = 0
    if n["RENDER_BG"] and n["N_OUTSIDE"] > 0:
        bg = bg_eval_count(tpu["BG_SAMPLES"], fg + n["N_OUTSIDE"], n["N_OUTSIDE"])
    return {"fg": fg, "bg": bg, "sampler": sampler}


def ray_flops(cfg: dict, train: bool, fine_grid: bool = True) -> float:
    """Operations one ray requires: a training step's (forward, input
    gradient and both backwards) or a served ray's (forward and input
    gradient)."""
    n = cfg["NEUCONW"]
    sdf, color = n["SDF_CONFIG"], n["COLOR_CONFIG"]
    s = samples_per_ray(cfg, fine_grid)
    mult = 3 if train else 1  # a forward, plus twice it for its backward
    c_sample, c_ray = color_products(color, n["N_A"], n["ENCODE_A"])
    b_point, b_ray = nerf_products(n["N_A"], n["ENCODE_A_BG"])
    fg = s["fg"] * (macs(sdf_products(sdf)) + macs(sdf_head_products(sdf)) + macs(c_sample))
    fg += macs(c_ray)
    bg = (s["bg"] * macs(b_point) + macs(b_ray)) if s["bg"] else 0
    sampler = s["sampler"] * macs(sdf_head_products(sdf))
    return 2.0 * (mult * (fg + bg) + sampler)
