"""The benchmark's CPU tests: tiny configurations of its cells run through
the harness with the port's plain paths; tests marked ``cuda`` run on a
card only (the decision is taken in the ``card`` fixture)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a tiny scene and field (width 64, four layers), shared by the tests
TINY_CFG = {"assumed": {"sfm_points": 2000, "sfm_voxel": 0.2, "fine_level": 5},
            "NEUCONW": {"SDF_CONFIG": {"d_hidden": 64, "d_out": 65, "n_layers": 4,
                                       "skip_in": [2]},
                        "COLOR_CONFIG": {"d_feature": 64, "d_hidden": 32, "n_layers": 2,
                                         "head_channels": 16},
                        "N_VOCAB": 16},
            "TPU": {"SCAN_INNER": 2}}
# batch 512: at 64 the bfloat16 gradient's rounding reads as far from the
# float32 reference as at none of the cell's own sizes
TINY_TRAFFIC = {"train_window": {"batch": 512, "views": 8, "wh": [16, 12],
                                 "trace_steps": 2},
                "serve_frames": {"wh": [16, 12], "chunk": 64, "frames": 2, "check_frames": 2,
                                 "check_rays": 64, "trace_frames": 1}}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the H100")
    return torch.device("cuda", 0)


def tiny_ctx(cell: str, seed: int = 4242):
    """A run's context for ``cell`` on the CPU at the tiny size."""
    import time

    from benchmark import harness

    wl = harness.workload(harness.spec(), cell)
    kind = harness.traffic(wl["traffic"])["kind"]
    return harness.Context(cell, wl, seed, 0.0, False, "cpu", time.perf_counter(), TINY_CFG,
                           TINY_TRAFFIC[kind])


def tiny_numbers(cell: str) -> dict:
    """Every number the check computes for ``cell`` at the tiny size, the
    compared ones and the others."""
    from benchmark import correct

    ctx = tiny_ctx(cell)
    if ctx.traffic["kind"] == "train_window":
        from benchmark.traffic import train_window as K

        p = K.build(ctx)
        first = K.first_steps(ctx, p)
        return correct.train_numbers(first, K.reference(ctx, p, first), p["weights"])
    from benchmark.traffic import serve_frames as K

    p = K.build(ctx)
    kept = [K.frame(ctx, p, i) for i in range(2)]
    picks = K.sample(ctx, 2)
    return K.numbers(kept, picks, K.reference(ctx, p, picks))


def tiny_run(cell: str, seed: int = 20260, seconds: float = 0.3, trace: bool = False, **kw):
    """One run of ``cell`` on the CPU at the tiny size."""
    import time

    from benchmark import harness

    kind = harness.traffic(harness.workload(harness.spec(), cell)["traffic"])["kind"]
    return harness.run(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                       cfg_over=TINY_CFG, traffic_over=TINY_TRAFFIC[kind], **kw)
