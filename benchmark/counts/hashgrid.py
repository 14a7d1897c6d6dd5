"""The work of a hash-grid SDF field's training step (``configs/
neuralangelo_op.json``), from the configuration's widths and sample counts.

Operations (``ray_flops``), counted as ``field.ray_flops`` counts the NeuS-W
field's: 2 k n a row of each product. A foreground sample: five
evaluations of the MLP up to its SDF column (the point and its four taps),
the feature columns once, and the colour head; a background sample the
NeRF++ products; a sampler point one evaluation up to the SDF column; the
parts the renderer takes once a ray once a ray. Training counts the
foreground's and the background's products three times (a forward, twice
it for its backward) and the sampler's once. The encoding is no product
and is left out.

Bytes, the least a kernel's work requires, for its roofline: K13 (the
encoding) reads each point (12 bytes) and writes its L F float32 features,
and reads each distinct table entry the step's encodings touch once (32
bytes), however often its points read it; K14 (the table's gradient) reads
each point and its L F gradients and reads and writes each distinct entry
the backward reaches once. An entry counted once a step is counted once
even where its level is small enough to stay in the card's 50 MB L2 across
the step's launches, so that no reading can pass 100 %."""

from __future__ import annotations

from .field import color_products, macs, nerf_products, samples_per_ray

ENTRY_BYTES = 32  # 8 float32 features
POINT_BYTES = 12


def is_hash(cfg: dict) -> bool:
    return cfg["NEUCONW"]["SDF_CONFIG"].get("type") == "hashgrid"


def width(sdf: dict) -> int:
    return int(sdf["levels"]) * int(sdf["features"])


def sdf_eval_products(sdf: dict) -> list:
    """(k, n) of the MLP's products up to its SDF column."""
    dims = [int(sdf["d_in"]) + width(sdf)] + [int(sdf["d_hidden"])] * int(sdf["n_layers"])
    return [(dims[l], dims[l + 1]) for l in range(len(dims) - 1)] + [(dims[-1], 1)]


def ray_flops(cfg: dict) -> float:
    """Operations one training ray requires."""
    n = cfg["NEUCONW"]
    sdf, color = n["SDF_CONFIG"], n["COLOR_CONFIG"]
    s = samples_per_ray(cfg)
    ev = macs(sdf_eval_products(sdf))
    feature = int(sdf["d_hidden"]) * (int(sdf["d_out"]) - 1)
    c_sample, c_ray = color_products(color, n["N_A"], n["ENCODE_A"])
    b_point, b_ray = nerf_products(n["N_A"], n["ENCODE_A_BG"])
    fg = s["fg"] * (5 * ev + feature + macs(c_sample)) + macs(c_ray)
    bg = (s["bg"] * macs(b_point) + macs(b_ray)) if s["bg"] else 0
    return 2.0 * (3 * (fg + bg) + s["sampler"] * ev)


def encode_points(cfg: dict, rays: int) -> int:
    """Points K13 encodes in a step of ``rays`` rays: the sampler's, and
    each foreground sample with its four taps."""
    s = samples_per_ray(cfg)
    return rays * (s["sampler"] + 5 * s["fg"])


def grad_points(cfg: dict, rays: int) -> int:
    """Points whose encoding's gradient K14 scatters in a step."""
    return rays * 5 * samples_per_ray(cfg)["fg"]


def encode_bytes(cfg: dict, points: int, entries: int) -> float:
    return points * (POINT_BYTES + 4.0 * width(cfg["NEUCONW"]["SDF_CONFIG"])) + \
        entries * ENTRY_BYTES


def grad_bytes(cfg: dict, points: int, entries: int) -> float:
    return points * (POINT_BYTES + 4.0 * width(cfg["NEUCONW"]["SDF_CONFIG"])) + \
        2.0 * entries * ENTRY_BYTES
