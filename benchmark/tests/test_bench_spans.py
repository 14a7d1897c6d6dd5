"""The span readers (``benchmark/spans.py``) on a synthetic device timeline:
the busy time strictly between each span's marker pairs over the units,
None without markers, and marker names that no kernel class takes."""

import pytest

from benchmark import spans as S
from benchmark import trace as T

from conftest import ROOT  # noqa: F401  (puts the checkout on the path)


def mark(name: str, end: int, t: float) -> T.Op:
    from neuralrecon_w_tpu_torch.tracing import BY_NAME

    return T.Op(f"void span_mark_kernel<{BY_NAME[name].id}, {end}>(unsigned long long*)",
                t, t + 1.0)


def synthetic() -> T.Trace:
    """Two steps of a 200 us window. Step 1: render_loss [0, 40] holds a
    kernel over [5, 15] and one over [10, 30]; backward [41, 80] holds
    [45, 70]; a gather kernel [85, 95] lies outside every span. Step 2:
    render_loss [100, 130] holds [105, 125]; backward [131, 170] holds
    [135, 160] and a kernel that runs past its end marker, [165, 175]."""
    ops = [mark("train.render_loss", 0, 0.0), T.Op("sdf_mlp_kernel", 5.0, 15.0),
           T.Op("field_fwd_kernel", 10.0, 30.0), mark("train.render_loss", 1, 39.0),
           mark("train.backward", 0, 40.0), T.Op("field_bwd_kernel", 45.0, 70.0),
           mark("train.backward", 1, 79.0), T.Op("index_select", 85.0, 95.0),
           mark("train.render_loss", 0, 100.0), T.Op("sdf_mlp_kernel", 105.0, 125.0),
           mark("train.render_loss", 1, 129.0), mark("train.backward", 0, 130.0),
           T.Op("field_bwd_kernel", 135.0, 160.0), T.Op("elementwise", 165.0, 175.0),
           mark("train.backward", 1, 170.0)]
    return T.Trace(sorted(ops, key=lambda o: o.start), [T.Op(T.WINDOW, 0.0, 200.0)],
                   (0.0, 200.0))


def test_reader_takes_busy_time_between_pairs_over_the_units():
    rec = {"trace": synthetic(), "train": True, "steps": 2, "batch": 8}
    # render_loss: [5, 30] (25 us) and [105, 125] (20 us); backward: [45, 70]
    # (25 us) and [135, 160] + [165, 170] (30 us)
    assert S.span_ms(rec, "train.render_loss") == pytest.approx(1e-3 * 45 / 2)
    assert S.span_ms(rec, "train.backward") == pytest.approx(1e-3 * 55 / 2)
    assert S.span_ms(rec, "train.optimizer") is None  # no marker of it
    assert S.span_ms(rec, "no.such_span") is None
    assert S.pairs(rec["trace"], 0) == [(1.0, 39.0), (101.0, 129.0)]


@pytest.mark.parametrize("metric,span", [("render_loss_ms.train", "train.render_loss"),
                                         ("backward_ms.train", "train.backward")])
def test_metric_files_read_their_span(metric, span):
    from benchmark import harness

    rec = {"trace": synthetic(), "train": True, "steps": 2, "batch": 8}
    assert harness.reader(metric).read(rec) == S.span_ms(rec, span)


def test_no_markers_read_none():
    tr = synthetic()
    bare = T.Trace([o for o in tr.ops if S.marker(o.name) is None], tr.host, tr.window)
    rec = {"trace": bare, "train": False, "chunks": 3, "chunk": 8, "rays": 20}
    for name in ("render_loss_ms.train", "backward_ms.train", "optimizer_ms.train",
                 "importance_ms.serve", "foreground_ms.serve", "background_ms.serve"):
        from benchmark import harness

        assert harness.reader(name).read(rec) is None, name


def test_no_marker_name_matches_a_kernel_class():
    """Every span's marker names, as the profiler gives them, match no
    pattern of ``metrics/kernel_classes.json``, and parse back."""
    from neuralrecon_w_tpu_torch.tracing import SPANS

    pats = [p.lower() for ps in T.kernel_classes().values() for p in ps]
    for s in SPANS:
        for end in (0, 1):
            name = mark(s.name, end, 0.0).name
            assert not any(p in name.lower() for p in pats), name
            assert S.marker(name) == (s.id, end)
    assert S.marker("void span_mark_kernel<3u, 1u>(unsigned long long*)") == (3, 1)
    assert S.marker("sdf_mlp_kernel") is None
