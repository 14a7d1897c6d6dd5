"""The plain reference against the port's plain paths, at a small width and a
tiny scene on the CPU: in float32 they agree to rounding (the reference
re-derives the band cache and the grid queries, and takes the sampler's
jitter as the program draws it); in bfloat16 the port rounds its products
and the gaps grow, but stay small."""

import pytest

from conftest import tiny_numbers

F32 = {"train.ref": {"loss_gap": 1e-5, "loss_first_gap": 1e-6, "color_term_gap": 1e-5,
                     "eikonal_term_gap": 1e-5, "mask_term_gap": 1e-5, "depth_term_gap": 1e-5,
                     "grad_gap": 1e-4, "grad_median_gap": 1e-5, "change_gap": 1e-3,
                     "change_median_gap": 1e-5},
       "serve.ref": {"color_gap": 1e-5, "depth_gap": 1e-5}}
BF16 = {"train.op": {"loss_gap": 1e-2, "grad_gap": 0.1, "change_gap": 0.1},
        "serve.op": {"color_gap": 1e-2, "depth_gap": 1e-2}}


@pytest.mark.parametrize("cell, bounds", list(F32.items()) + list(BF16.items()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_reference_agrees_with_the_port(cell, bounds):
    numbers = tiny_numbers(cell)
    for name, bound in bounds.items():
        assert numbers[name] <= bound, (name, numbers)


def test_jitter_follows_the_program_stream():
    """The plain loop's per-step generators: each step's draws are those of
    a generator seeded with (seed, step), as ``step.step_generator`` makes
    them."""
    import torch

    from neuralrecon_w_tpu_torch.training.step import step_generator

    from benchmark.traffic.train_window import jitter_draws

    draws = jitter_draws(False, 17, 3, 2, 5, 4, "cpu")
    for i, (t, z) in enumerate(draws):
        g = step_generator(17, 3 + i, "cpu")
        assert torch.equal(t, torch.rand(5, 1, generator=g))
        assert torch.equal(z, torch.rand(5, 4, generator=g))
