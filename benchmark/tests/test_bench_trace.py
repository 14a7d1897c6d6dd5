"""The trace arithmetic on a synthetic device timeline, and the rate over a
window that holds a stall."""

import time

import pytest

from benchmark import metrics
from benchmark import trace as T

from conftest import tiny_run


def synthetic() -> T.Trace:
    """A 100 us window: kernels over [10, 30] and [25, 40] (overlapping),
    a copy over [50, 55], a GEMM over [70, 90]; host ranges around them."""
    ops = [T.Op("void sdf_mlp_kernel<bf16>(float const*, long long)", 10.0, 30.0),
           T.Op("up_sample_kernel", 25.0, 40.0),
           T.Op("Memcpy HtoD (Pageable -> Device)", 50.0, 55.0),
           T.Op("sm90_xmma_gemm_bf16bf16_bf16f32", 70.0, 90.0),
           T.Op("late_kernel", 120.0, 130.0)]
    host = [T.Op(T.WINDOW, 0.0, 100.0), T.Op("bench.dispatch", 0.0, 60.0),
            T.Op("bench.fetch", 60.0, 100.0)]
    return T.Trace(ops, host, (0.0, 100.0))


def test_busy_is_the_union_inside_the_window():
    tr = synthetic()
    assert T.busy_intervals(tr) == [[10.0, 40.0], [50.0, 55.0], [70.0, 90.0]]
    assert T.busy_seconds(tr) == pytest.approx(55e-6)
    assert T.window_seconds(tr) == pytest.approx(100e-6)
    assert metrics.idle_pct({"trace": tr}) == pytest.approx(45.0)


def test_idle_gaps_are_labelled_by_the_open_host_range():
    gaps = T.idle_gaps(synthetic())
    assert [g[0] for g in gaps] == ["bench.fetch", "bench.dispatch", "bench.dispatch",
                                    "bench.fetch"]
    assert [g[1] for g in gaps] == pytest.approx([15e-6, 10e-6, 10e-6, 10e-6])


def test_kernels_classes_and_top_ops():
    tr = synthetic()
    assert T.count_kernels(tr) == 3  # the copy and the kernel after the window left out
    rec = {"trace": tr, "train": True, "steps": 2, "batch": 8}
    assert metrics.kernels_per_unit(rec) == 1.5
    assert metrics.class_ms(rec, "gemm") == pytest.approx(1e3 * 20e-6 / 2)  # the GEMM alone
    assert metrics.class_ms(rec, "sampler") == pytest.approx(1e3 * 35e-6 / 2)
    assert metrics.class_ms(rec, "grid_query") is None
    with pytest.raises(RuntimeError):
        metrics.class_ms(rec, "grid_query", required=True)
    top = T.top_ops(tr)
    assert top[0] == ["void sdf_mlp_kernel<bf16>", pytest.approx(20e-6)]


@pytest.mark.parametrize("name", ["void sdf_mlp_kernel<bf16>", "up_sample_kernel", "dda_kernel",
                                  "coarse_kernel", "sampled_hit_kernel", "sdf_vjp_bwd_kernel",
                                  "sm90_xmma_gemm_bf16bf16_bf16f32",
                                  "cutlass_75_tensorop_bf16_s1688gemm_bf16_256x128_32x2_nn_align1"])
def test_each_kernel_belongs_to_one_layer(name):
    """A kernel's time counts in one layer's metric only."""
    classes = T.kernel_classes()
    assert sum(any(p.lower() in name.lower() for p in pats) for pats in classes.values()) == 1


def test_a_window_holding_a_stall_reads_lower(monkeypatch):
    """The rate is all the work over all the time of the window: a stall in
    one dispatch lowers it."""
    from benchmark.traffic import train_window

    plain = tiny_run("train.op", seconds=1.0)["metrics"]["train_rays_per_s"]["value"]
    real = train_window.dispatch
    calls = []

    def stalled(ctx, p):
        calls.append(1)
        t0 = time.perf_counter()
        out = real(ctx, p)
        if len(calls) == 1:  # the first dispatch takes at least twice as long
            time.sleep(max(1.5, time.perf_counter() - t0))
        return out

    monkeypatch.setattr(train_window, "dispatch", stalled)
    r = tiny_run("train.op", seconds=1.0)
    assert r["metrics"]["train_rays_per_s"]["value"] < 0.8 * plain
    assert r["attempted"] == 2 * len(calls)
