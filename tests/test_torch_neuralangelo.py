"""PyTorch port, Neuralangelo's hash-grid SDF field against the plain
reference (``neuralrecon_w_tpu_torch/testing/reference_neuralangelo.py``)
on seeded random weights at a small size with dense and hashed levels
(6 levels, 2^12 entries a level, 8 features, MLP 1 x 32): the encoding and
its table gradient, the field, the four-tap gradient and the Laplacian
against autograd in float64, the level mask, the geometry loss, its
gradients and the AdamW update, a training step through the captured
dispatch's call against the benchmark's reference, and the refresh sweep.
Tests marked ``cuda`` hold K13 / K14 to their plain versions on a card."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg  # noqa: E402
from neuralrecon_w_tpu_torch.testing import reference_neuralangelo as R  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "neuralrecon_w_tpu_torch", "configs", "train_neuralangelo_op.yaml")
SMALL = {"levels": 6, "log2_table": 12, "min_res": 4, "max_res": 64, "d_hidden": 32,
         "d_out": 33}

torch.set_num_threads(2)


def small_cfg(**sdf):
    cfg = load_cfg(YAML)
    n = cfg.NEUCONW
    for k, v in {**SMALL, **sdf}.items():
        n.SDF_CONFIG[k] = v
    n.COLOR_CONFIG.d_feature, n.COLOR_CONFIG.d_hidden, n.COLOR_CONFIG.n_layers = 32, 32, 2
    n.N_VOCAB = 16
    return cfg


def live_field(cfg, seed=0, device="cpu"):
    """The field with its init, then the table N(0, 0.1) and layer 0's
    encoding columns at torch's default scale, so the grid moves the sdf."""
    from neuralrecon_w_tpu_torch.models.neuconw import init_field

    fc = field_config_from_cfg(cfg)
    g = torch.Generator().manual_seed(seed)
    model = init_field(fc, g, device)
    net = model.neuconw.sdf_net
    with torch.no_grad():
        net.table.copy_(torch.randn(net.table.shape, generator=g) * 0.1)
        v = net.lin0.weight_v
        v[:, 3:] = (torch.rand(v[:, 3:].shape, generator=g) * 2 - 1) / v.shape[1] ** 0.5
        net.lin0.weight_g.copy_(torch.linalg.vector_norm(v, dim=1, keepdim=True))
    return fc, model


def params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def points(n, seed=1, scale=0.9):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, 3, generator=g) * 2 - 1) * scale


def test_published_layout():
    """16 levels from 32 to 2048, the six coarse ones dense, 45.7 M entries."""
    from neuralrecon_w_tpu_torch.config import HASH_SDF_CONFIG
    from neuralrecon_w_tpu_torch.ops.hash_grid import grid_spec

    spec = grid_spec(HASH_SDF_CONFIG)
    assert spec.res[0] == 32 and spec.res[5] == 128 and spec.res[-1] == 2048
    assert spec.dense == (True,) * 6 + (False,) * 10
    assert spec.n_entries == R.n_entries(HASH_SDF_CONFIG) == 45_727_205
    assert [n for n, _, _ in R.layout(HASH_SDF_CONFIG)] == list(spec.res)


def test_small_size_has_dense_and_hashed_levels():
    cfg = small_cfg()
    dense = [d for _, _, d in R.layout(dict(cfg.NEUCONW.SDF_CONFIG))]
    assert any(dense) and not all(dense)


@pytest.mark.parametrize("active", [1, 4, 6])
def test_encoding_and_table_gradient(active):
    """The plain K13 / K14 against the reference's gathers and autograd's
    gradient of them; outside [-2, 2] the point is clamped."""
    from neuralrecon_w_tpu_torch.ops.hash_grid import HashEncode

    cfg = small_cfg()
    fc, model = live_field(cfg)
    net = model.neuconw.sdf_net
    x = torch.cat([points(3000, scale=1.9), points(20, seed=5, scale=2.5)])
    act = torch.tensor(active, dtype=torch.int32)
    table = net.table.detach().clone().requires_grad_(True)
    got = HashEncode.apply(x, table, net.spec, act)
    ref_table = table.detach().clone().requires_grad_(True)
    want = R.encode(fc.sdf_cfg, ref_table, x, active)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert (got[:, active * 8:] == 0).all()
    gy = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    (got * gy).sum().backward()
    (want * gy).sum().backward()
    torch.testing.assert_close(table.grad, ref_table.grad, rtol=1e-5, atol=1e-5)
    assert table.grad[net.spec.offsets[active]:].abs().sum() == 0 if active < 6 else True


@pytest.mark.parametrize("active", [4, 9, 16])
def test_level_mask(active):
    """At 4, 9 and 16 of 16 levels: the columns past the active count are
    zero, the rest the reference's; the schedule's step gives the count,
    and the taps' distance is 1 / N of the last active level over sqrt 3."""
    from neuralrecon_w_tpu_torch.ops.hash_grid import hash_encode

    cfg = small_cfg(levels=16, min_res=4, max_res=256, log2_table=10)
    fc, model = live_field(cfg)
    net = model.neuconw.sdf_net
    net.set_step((active - 4) * 5000)
    assert int(net.active) == active
    x = points(500)
    got = hash_encode(x, net.table.detach(), net.spec, net.active)
    torch.testing.assert_close(got, R.encode(fc.sdf_cfg, net.table.detach(), x, active),
                               rtol=0, atol=1e-6)
    assert (got[:, active * 8:] == 0).all() and (got[:, :active * 8].abs().sum(0) > 0).all()
    torch.testing.assert_close(net.tap_distance(), R.tap_distance(fc.sdf_cfg, active))
    # the same schedule read from a device-style counter (a captured step's)
    net.set_step(torch.tensor(float((active - 4) * 5000 + 4999), dtype=torch.float64))
    assert int(net.active) == active
    assert net.levels_at(10 ** 6) == 16


def test_field_sdf_feature_and_taps_match_reference():
    """field_sdf, and the taps' sdf, feature, gradient and Laplacian, in
    float32 against the reference's."""
    from neuralrecon_w_tpu_torch.models.hash_sdf import hash_sdf_feat_grad
    from neuralrecon_w_tpu_torch.models.neuconw import field_sdf

    cfg = small_cfg()
    fc, model = live_field(cfg)
    p = params(model)
    x = points(2000)
    with torch.no_grad():
        s = field_sdf(model, fc, x)
        f0, feat, grad, lap = hash_sdf_feat_grad(model.neuconw.sdf_net, x, laplacian=True)
        rf0, rfeat, rgrad, rlap = R.taps(p, fc.sdf_cfg, x, 6)
    torch.testing.assert_close(s, rf0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(f0, rf0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(feat, rfeat, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grad, rgrad, rtol=1e-3, atol=1e-3)
    # a float32 Laplacian divides differences of ~1e-7 by e^2 (~1e-4 here)
    assert (lap - rlap).abs().max() < 5e-2 * max(1.0, float(rlap.abs().max()))


def test_taps_against_autograd_float64():
    """Where every tap of a point stays in the point's cell at every level
    (the encoding is smooth there), the port's float32 taps are as close to
    the float64 autograd gradient and Hessian trace as the taps' own
    Taylor error allows (the float64 taps' distance to them) plus float32
    rounding."""
    from neuralrecon_w_tpu_torch.models.hash_sdf import hash_sdf_feat_grad

    cfg = small_cfg()
    fc, model = live_field(cfg)
    sc = fc.sdf_cfg
    p64 = {k: v.double() for k, v in params(model).items()}
    x = points(6000, seed=7)
    e = float(R.tap_distance(sc, 6))
    k = torch.tensor(R.TAPS, dtype=torch.float32)
    keep = torch.ones(len(x), dtype=torch.bool)
    for l in range(6):
        cell = R.corner_rows(sc, l, x)[0][:, 0]
        for i in range(4):
            keep &= R.corner_rows(sc, l, x + e * k[i])[0][:, 0] == cell
    x = x[keep]
    assert len(x) > 200
    with torch.no_grad():
        _, _, grad, lap = hash_sdf_feat_grad(model.neuconw.sdf_net, x, laplacian=True)
    _, _, g64, l64 = R.taps(p64, sc, x.double(), 6)
    ga, tr = R.analytic(p64, sc, x.double(), 6)
    taylor_g = (g64 - ga).norm(dim=-1)
    taylor_l = (l64 - tr).abs()
    assert ((grad.double() - ga).norm(dim=-1) <= 2 * taylor_g + 2e-3).all()
    assert ((lap.double() - tr).abs() <= 2 * taylor_l + 5e-2 * (1 + tr.abs())).all()
    # second order in e, at least: halving e shrinks the taps' error
    _, _, g_half, _ = R.taps(p64, sc, x.double(), 6, e=e / 2)
    assert float((g_half - ga).norm(dim=-1).mean()) < 0.6 * float(taylor_g.mean())


def test_geometry_loss_gradients_and_adamw():
    """The eikonal and curvature terms on the port's taps, their gradient
    in every leaf of the SDF net (the table's included), the clip and one
    AdamW step of the port's optimiser, against the reference's."""
    from neuralrecon_w_tpu_torch.models.hash_sdf import hash_sdf_feat_grad
    from neuralrecon_w_tpu_torch.training.schedule import make_optimizer

    cfg = small_cfg()
    cfg.TRAINER.GRAD_CLIP = 0.05  # small enough that the clip acts
    fc, model = live_field(cfg)
    net = model.neuconw.sdf_net
    sc = fc.sdf_cfg
    x = points(3000, seed=9)
    w = (x.norm(dim=-1) < 1.2).float()
    p0 = params(model)
    _, _, grad, lap = hash_sdf_feat_grad(net, x, laplacian=True)
    den = w.sum() + 1e-5
    loss = (0.1 * torch.sum(w * (grad.norm(dim=-1) - 1.0) ** 2) / den
            + float(sc["curvature_weight"]) * net.curvature_decay()
            * torch.sum(w * lap.abs()) / den)
    spec, _ = make_optimizer(cfg, 512)
    opt = spec.init(model.parameters())
    opt.zero_grad()
    loss.backward()
    names = [k for k, q in model.named_parameters() if q.grad is not None]
    assert all(k.startswith("neuconw.sdf_net.") for k in names) and len(names) == 7
    p = {k: v.clone().requires_grad_(k in names) for k, v in p0.items()}
    t = R.geometry_loss(p, sc, x, w, 6, 0.1)
    torch.testing.assert_close(loss.detach(), t["loss"].detach(), rtol=2e-4, atol=1e-7)
    rg = torch.autograd.grad(t["loss"], [p[k] for k in names])
    named = dict(model.named_parameters())
    for k, g in zip(names, rg):
        torch.testing.assert_close(named[k].grad, g, rtol=2e-3, atol=1e-6, msg=k)
    opt.step()
    grads = {k: g.clone() for k, g in zip(names, rg)}
    R.clip_(grads, 0.05)
    ref = {k: p0[k].clone() for k in names}
    R.adamw_step_(ref, grads, {k: torch.zeros_like(v) for k, v in ref.items()},
                  {k: torch.zeros_like(v) for k, v in ref.items()}, 1,
                  float(cfg.TRAINER.LR), float(cfg.TRAINER.WEIGHT_DECAY))
    # a leaf whose gradient is round-off (the sdf bias: the geometry terms
    # take differences of the sdf) moves by Adam's sign of noise
    norms = {k: float(g.norm()) for k, g in zip(names, rg)}
    median = sorted(norms.values())[len(norms) // 2]
    for k in [k for k in names if norms[k] >= 1e-3 * median]:
        d_port, d_ref = named[k].detach() - p0[k], ref[k] - p0[k]
        assert float((d_port - d_ref).norm()) <= 1e-2 * float(d_ref.norm()) + 1e-9, k


def test_refresh_sweep_through_the_hash_field():
    """The surface refresh's SDF sweep (and mesh extraction's) evaluates
    the hash field, not K1."""
    from neuralrecon_w_tpu_torch.parallel.sweep import sharded_sdf_sweep

    cfg = small_cfg()
    fc, model = live_field(cfg)
    model.neuconw.sdf_net.set_step(5000)
    x = points(5000, seed=11)
    got = sharded_sdf_sweep(model, fc, x.numpy(), chunk=1024, device="cpu")
    want, _ = R.sdf_feature(params(model), fc.sdf_cfg, x, 5)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tpu", [{"SDF_GRAD_MODE": "pallas"}, {"SDF_GRAD_MODE": "fwd"},
                                 {"FIELD_DTYPE": "bfloat16"}])
def test_hash_field_refuses_other_modes(tpu):
    from neuralrecon_w_tpu_torch.models.neuconw import NeuconWField

    cfg = small_cfg()
    for k, v in tpu.items():
        cfg.TPU[k] = v
    with pytest.raises(ValueError, match="hashgrid"):
        NeuconWField(field_config_from_cfg(cfg), "cpu")


def test_yaml_is_outside_the_scene_configs():
    """The JAX package's schema reads config/*.yaml; the hash-grid YAML is
    the port's own, and its MLP keys are gone."""
    import glob

    assert YAML not in glob.glob(os.path.join(ROOT, "config", "*.yaml"))
    sdf = load_cfg(YAML).NEUCONW.SDF_CONFIG
    assert sdf.type == "hashgrid" and "multires" not in sdf and sdf.levels == 16


@pytest.fixture(scope="module")
def tiny_cell():
    """The train.neuralangelo cell at a tiny size on the CPU: its set-up,
    its three steps through the captured dispatch's call (the plain loop on
    the CPU) and the benchmark's reference of them."""
    sys.path.insert(0, ROOT)
    import time

    from benchmark import harness
    from benchmark.traffic import train_window_hash as K

    wl = harness.workload(harness.spec(), "train.neuralangelo")
    ctx = harness.Context("train.neuralangelo", wl, 4242, 0.0, False, "cpu",
                          time.perf_counter(), K.TINY_CFG, K.TINY_TRAFFIC)
    p = K.build(ctx)
    first = K.first_steps(ctx, p)
    return K, ctx, p, first, K.reference(ctx, p, first)


def test_training_step_against_the_benchmark_reference(tiny_cell):
    """The tiny cell's steps against the benchmark's reference from the
    same weights, rows and jitter: the first loss, every leaf's first
    gradient, the change, the rows, and the table's own gradient and
    change."""
    K, ctx, p, first, ref = tiny_cell
    n = K.numbers(first, ref, p["weights"], ref["rows"], ctx.cfg["NEUCONW"]["SDF_CONFIG"])
    assert n["rows_off"] == 0
    assert n["loss_first_gap"] < 1e-5 and n["loss_gap"] < 1e-4, n
    assert n["grad_median_gap"] < 1e-4 and n["grad_dir_median_gap"] < 1e-3, n
    assert n["grad_unit_median_gap"] < 1e-4, n
    assert n["change_median_gap"] < 1e-3, n
    assert n["table_rows_grad_gap"] < 1e-4 and n["table_rows_change_gap"] < 1e-4, n
    assert n["table_grad_unit_gap"] < 1e-3 and n["table_change_gap"] < 1e-2, n
    assert set(first["grads"]) == set(ref["grads"]) and "neuconw.sdf_net.table" in ref["grads"]
    assert "curvature_loss" in first["losses"][0]


@pytest.mark.parametrize("fault", ["zero", "drop0", "drop5", "shift", "unchanged"])
def test_table_faults_read_in_the_table_numbers(tiny_cell, fault):
    """The table's gradient broken as a faulty K14 would break it (nothing
    scattered, the coarsest or the finest level's rows left out, each
    level's rows one entry on), planted in the reference in the program's
    place, or the table left unchanged by the steps: the table's numbers
    by level read it (0.5 or more, where the program reads under 1e-4),
    and the median over the leaves does not (round-off: one leaf of ~50)."""
    from benchmark.reference.neuralangelo import Faults

    K, ctx, p, first, ref = tiny_cell
    w = p["weights"]
    if fault == "unchanged":
        side = dict(first, params=dict(first["params"], **{K.TABLE: w[K.TABLE]}))
    else:
        side = K.reference(ctx, p, first, faults=Faults(table_grad=fault))
    n = K.numbers(side, ref, w, ref["rows"], ctx.cfg["NEUCONW"]["SDF_CONFIG"])
    assert n["table_rows_change_gap"] >= 0.5, n
    assert n["table_rows_grad_gap"] >= 0.5 or fault == "unchanged", n
    assert n["grad_unit_median_gap"] < 1e-6, n
    if fault == "unchanged":
        assert n["table_change_gap"] == 1.0, n


def test_table_fault_names():
    """table_grad_fault leaves out one level's rows, or moves each level's
    rows one entry on, and refuses a fault it does not know."""
    sys.path.insert(0, ROOT)
    from benchmark.reference import hashgrid as H

    sdf = {"levels": 2, "log2_table": 6, "min_res": 2, "max_res": 8}
    g = torch.arange(float(H.n_entries(sdf) * 2)).view(-1, 2)
    (_, off1, _) = H.layout(sdf)[1]
    assert torch.equal(H.table_grad_fault(sdf, g, "drop1")[:off1], g[:off1])
    assert not H.table_grad_fault(sdf, g, "drop1")[off1:].any()
    shifted = H.table_grad_fault(sdf, g, "shift")
    assert torch.equal(shifted[1:off1], g[:off1 - 1]) and torch.equal(shifted[0], g[off1 - 1])
    for bad in ("drop2", "drop", "roll"):
        with pytest.raises(ValueError):
            H.table_grad_fault(sdf, g, bad)


def test_chip_smoke_rehearsal_on_the_cpu(tmp_path, capsys):
    """``chip_smoke_neuralangelo.py --tiny`` on the CPU: train_cli across a
    refresh and two level increases, then render_cli's frame, and PASS."""
    sys.path.insert(0, ROOT)
    import chip_smoke_neuralangelo as smoke

    rc = smoke.main(["--device", "cpu", "--tiny", "--steps", "12", "--update", "6",
                     "--level_every", "4", "--batch", "256", "--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "PASS" in out, out[-3000:]
    assert "active levels 6 (schedule 6)" in out and "refresh at step 6" in out


# ------------------------------- the card -------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K13 / K14 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def assert_atomic_sums(got, want, magnitude):
    """K14's sums against the plain version's: float atomics add in another
    order, so an entry may differ by its sum of |terms| times a few
    thousand float32 roundings' worth (1e-5), and by no more."""
    err = (got - want).abs()
    assert bool((err <= 1e-5 * magnitude + 1e-6).all()), float((err / (magnitude + 1e-6)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("active", [3, 6])
def test_k13_k14_match_plain(dev, active):
    """K13 against the plain encoding, K14 against the plain scatter-add
    (to float atomics' rounding), on the small grid and on points outside
    the bound."""
    from neuralrecon_w_tpu_torch.ops.hash_grid import (hash_encode, hash_encode_plain,
                                                       hash_grad, hash_grad_plain)

    cfg = small_cfg()
    fc, model = live_field(cfg, device=dev)
    net = model.neuconw.sdf_net
    table = net.table.detach()
    act = torch.tensor(active, dtype=torch.int32, device=dev)
    x = torch.cat([points(200_000, scale=1.9), points(100, seed=5, scale=2.5)]).to(dev)
    before = hash_encode.launches, hash_encode.points, hash_grad.launches
    got = hash_encode(x, table, net.spec, act)
    torch.testing.assert_close(got, hash_encode_plain(x, table, net.spec, act), rtol=1e-5,
                               atol=1e-6)
    gy = torch.randn(got.shape, device=dev)
    g = hash_grad(x, gy, net.spec, act)
    assert_atomic_sums(g, hash_grad_plain(x, gy, net.spec, act),
                       hash_grad_plain(x, gy.abs(), net.spec, act))
    assert (hash_encode.launches, hash_encode.points, hash_grad.launches) == (
        before[0] + 1, before[1] + len(x), before[2] + 1)


@pytest.mark.cuda
def test_k13_k14_at_the_published_size(dev):
    """At the published layout (16 levels, 2^22 entries a level), all levels
    active: K13 and K14 against their plain versions."""
    from neuralrecon_w_tpu_torch.config import HASH_SDF_CONFIG
    from neuralrecon_w_tpu_torch.ops.hash_grid import (grid_spec, hash_encode, hash_encode_plain,
                                                       hash_grad, hash_grad_plain)

    spec = grid_spec(HASH_SDF_CONFIG)
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(spec.n_entries, 8, device=dev, generator=g) * 0.1
    act = torch.tensor(16, dtype=torch.int32, device=dev)
    x = (torch.rand(65536, 3, device=dev, generator=g) * 2 - 1) * 1.2
    got = hash_encode(x, table, spec, act)
    torch.testing.assert_close(got, hash_encode_plain(x, table, spec, act), rtol=1e-5, atol=1e-6)
    gy = torch.randn(got.shape, device=dev, generator=g)
    assert_atomic_sums(hash_grad(x, gy, spec, act), hash_grad_plain(x, gy, spec, act),
                       hash_grad_plain(x, gy.abs(), spec, act))


@pytest.mark.cuda
def test_k13_replay_reads_the_active_count(dev):
    """A captured K13 reads the active count from device memory: a replay
    after the count changes in place encodes at the new count."""
    from neuralrecon_w_tpu_torch.ops.hash_grid import hash_encode, hash_encode_plain

    cfg = small_cfg()
    fc, model = live_field(cfg, device=dev)
    net = model.neuconw.sdf_net
    table = net.table.detach()
    act = torch.tensor(2, dtype=torch.int32, device=dev)
    x = points(4096).to(dev)
    hash_encode(x, table, net.spec, act)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = hash_encode(x, table, net.spec, act)
    for a in (2, 5):
        act.fill_(a)
        graph.replay()
        torch.testing.assert_close(out, hash_encode_plain(x, table, net.spec, act), rtol=1e-5,
                                   atol=1e-6)
        assert (out[:, a * 8:] == 0).all()
