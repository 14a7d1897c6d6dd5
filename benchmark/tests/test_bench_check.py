"""The comparison that decides ``correct``, at a size a test run holds, with
each cell's own limits: a sound tiny run passes; the control (the reference
computed in the precision below the configuration's, put in the program's
place) fails; and each fault a cell can have, planted in the port under a
whole run on the CPU, turns ``correct`` false. The same control on the card
at the cells' own size is ``benchmark/calibrate.py``'s "control"."""

import pytest
import torch

from benchmark import correct

from conftest import tiny_ctx, tiny_run


@pytest.mark.parametrize("cell", ["train.op", "train.ref"])
def test_training_control_fails(cell):
    from benchmark.traffic import train_window as K

    ctx = tiny_ctx(cell)
    p = K.build(ctx)
    first = K.first_steps(ctx, p)
    ref = K.reference(ctx, p, first)
    ctl = K.reference(ctx, p, first, ctx.control)
    assert correct.judge(correct.train_numbers(first, ref, p["weights"]), ctx.limits)
    assert not correct.judge(correct.train_numbers(ctl, ref, p["weights"]), ctx.limits)


@pytest.mark.parametrize("cell", ["serve.op", "serve.ref"])
def test_serving_control_fails(cell):
    from benchmark.traffic import serve_frames as K

    ctx = tiny_ctx(cell)
    p = K.build(ctx)
    kept = [K.frame(ctx, p, i) for i in range(2)]
    picks = K.sample(ctx, 2)
    ref = K.reference(ctx, p, picks)
    ctl = K.reference(ctx, p, picks, ctx.control)
    assert correct.judge(K.numbers(kept, picks, ref), ctx.limits)
    cat = lambda outs, i: torch.cat([o[i] for o in outs])  # noqa: E731
    assert not correct.judge(correct.serve_numbers(cat(ctl, 0), cat(ctl, 1), cat(ref, 0),
                                                   cat(ref, 1)), ctx.limits)


# ------------------------------- faults -------------------------------


def state_unchanged(monkeypatch):
    """The optimiser counts its step and updates nothing."""
    from neuralrecon_w_tpu_torch.training import schedule

    def step(self):
        self.count += 1

    monkeypatch.setattr(schedule.Optimizer, "step", step)


def half_batch(monkeypatch):
    """Each step renders and averages the first half of its batch only."""
    from neuralrecon_w_tpu_torch.training import step as S

    real = S.make_train_step

    def make(*a, **kw):
        fn = real(*a, **kw)

        def half(state, scene, batch, *rest):
            n = next(iter(batch.values())).shape[0] // 2
            return fn(state, scene, {k: v[:n] for k, v in batch.items()}, *rest)

        half.__dict__.update(fn.__dict__)
        return half

    monkeypatch.setattr(S, "make_train_step", make)


def stale_window(monkeypatch):
    """The pool hands out its first window again and again: rows repeated."""
    from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool

    real = DeviceRayPool.take_scan_window

    def take(self, batch_size, n_inner):
        perm, _ = real(self, batch_size, n_inner)
        return perm, 0

    monkeypatch.setattr(DeviceRayPool, "take_scan_window", take)


def answer_altered(monkeypatch):
    """A quarter of each served chunk's colours shifted where they are made."""
    from neuralrecon_w_tpu_torch.training.step import ScanRender

    real = ScanRender.body

    def body(self, *a, **kw):
        color, depth, normal = real(self, *a, **kw)
        shift = torch.zeros_like(color)
        shift[: len(color) // 4] = 0.2
        return color + shift, depth, normal

    monkeypatch.setattr(ScanRender, "body", body)


def half_chunk(monkeypatch):
    """Half of each served chunk left out: its rays come back as zeros."""
    from neuralrecon_w_tpu_torch.training.step import ScanRender

    real = ScanRender.body

    def body(self, model, scene, rays, ts, labels, *rest):
        n = len(rays) // 2
        color, depth, normal = real(self, model, scene, rays[:n], ts[:n], labels[:n], *rest)
        z = lambda t: torch.cat([t, torch.zeros_like(t)])  # noqa: E731
        return z(color), z(depth), z(normal)

    monkeypatch.setattr(ScanRender, "body", body)


@pytest.mark.parametrize("cell, fault", [
    ("train.op", state_unchanged), ("train.op", half_batch), ("train.op", stale_window),
    ("train.ref", state_unchanged), ("train.ref", half_batch), ("train.ref", stale_window),
    ("serve.op", answer_altered), ("serve.op", half_chunk),
    ("serve.ref", answer_altered), ("serve.ref", half_chunk)],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, cell, fault):
    assert tiny_run(cell)["correct"]
    fault(monkeypatch)
    assert not tiny_run(cell)["correct"]
