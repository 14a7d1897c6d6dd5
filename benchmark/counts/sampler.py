"""The importance sampler's work, K1 (the SDF net up to its SDF column at
the sampler's points) and K2 (the up-sampling rounds), for a batch of
rays: operations and bytes, and the least time of each launch.

K1 a launch: the products of ``field.sdf_head_products`` a point; bytes the
points read (3 float32) and the SDF written (1 float32) a point, and the
weights once in the field's dtype. K2 a round: no product; bytes each
ray's origin and direction (6 float32), the rows it merges (z and sdf of
both sets) and the rows it writes (the merged z and sdf and the draws, or
on the last round the final z). Each input byte is read once and each
output byte written once, whatever the kernels read again.

The rounds follow ``ops/importance_sampler.fused_importance_sampler`` of
the port: round 0 takes the n_samples base samples; round i > 0 merges
the previous rows with the n_importance / steps draws of round i - 1."""

from __future__ import annotations

from .field import macs, sdf_head_products
from .peaks import least_seconds

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def launches(cfg: dict, rays: int) -> list:
    """(kernel, flops, bytes) of each K1 and K2 launch for ``rays`` rays."""
    n = cfg["NEUCONW"]
    sdf = n["SDF_CONFIG"]
    dtype = cfg["dtype"]
    head = sdf_head_products(sdf)
    w_bytes = sum(k * m + m for k, m in head) * DTYPE_BYTES[dtype]
    steps, n0 = n["UP_SAMPLE_STEP"], n["N_SAMPLES"]
    per = n["N_IMPORTANCE"] // steps

    def k1(points):
        return ("K1", 2.0 * points * macs(head), points * 16.0 + w_bytes)

    out = [k1(rays * n0)]
    for i in range(steps):
        na = n0 + max(i - 1, 0) * per
        nb = per if i > 0 else 0
        width = na + nb
        read = 6 + 2 * na + 2 * nb
        write = width + per if i == steps - 1 else 2 * width + per
        out.append(("K2", 0.0, 4.0 * rays * (read + write)))
        if i < steps - 1:
            out.append(k1(rays * per))
    return out


def least_ms(cfg: dict, rays: int) -> float:
    """The least time of the sampler's K1 and K2 launches for ``rays``
    rays, each launch at its own bound, summed."""
    dtype = cfg["dtype"]
    return 1e3 * sum(least_seconds(f, b, dtype) for _, f, b in launches(cfg, rays))
