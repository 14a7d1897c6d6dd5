"""``chip_smoke.py`` on the CPU: it refuses to run without a CUDA card,
and its scene and checks, at a tiny width, drive the port's serving path
without importing JAX or the JAX package."""

import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(argv, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT if cwd == ROOT else "")
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    """No card, or the script without the repo: a non-zero exit and no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("checks the run on a machine without a CUDA card")
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = run(["chip_smoke.py"], cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_live_sdf_net_reaches_every_input():
    """The kernel checks run on a noisy copy of the served SDF net: the
    served net is untouched, and the sin / cos columns of layer 0, the PE
    half of the skip input and the hidden biases, zero at the geometric
    init, each move sdf far past K1's bounds."""
    sys.path.insert(0, ROOT)
    from chip_smoke import live_sdf_net
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg
    from neuralrecon_w_tpu_torch.ops.sdf_mlp import pack_sdf_weights, sdf_mlp_plain
    from neuralrecon_w_tpu_torch.models.neuconw import init_field

    torch.set_num_threads(1)
    cfg = load_cfg(os.path.join(ROOT, "config", "train_brandenburg_gate_tpu.yaml"))
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
    n.SDF_CONFIG.skip_in = (2,)
    n.COLOR_CONFIG.d_feature, n.N_VOCAB = 64, 4
    fc = field_config_from_cfg(cfg)
    net = init_field(fc, torch.Generator().manual_seed(0), "cpu").neuconw.sdf_net.requires_grad_(False)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    live = live_sdf_net(net)
    assert all(torch.equal(before[k], v) for k, v in net.state_dict().items())
    assert float(net.lin0.weight_v[:, 3:].abs().max()) == 0.0
    assert float(live.lin0.weight_v[:, 3:].abs().min()) > 0.0
    assert float(live.lin1.bias.abs().min()) > 0.0

    pts = torch.rand(256, 3, generator=torch.Generator().manual_seed(1)) * 1.8 - 0.9
    want = sdf_mlp_plain(pack_sdf_weights(live, fc.sdf), pts)
    with torch.no_grad():
        for name, zero in [("lin0.weight_v", (slice(None), slice(3, None))),  # sin / cos
                           ("lin2.weight_v", (slice(None), slice(-36, None))),  # skip PE
                           ("lin1.bias", (slice(None),))]:
            cut = live_sdf_net(net)
            getattr(cut, name.split(".")[0]).get_parameter(name.split(".")[1])[zero] = 0.0
            moved = (sdf_mlp_plain(pack_sdf_weights(cut, fc.sdf), pts) - want).abs().max()
            assert float(moved) > 1e-3, name


def test_chip_smoke_scene_serves_without_jax_package():
    code = """
import sys
import numpy as np
import torch
import chip_smoke as cs
from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg, render_config_from_cfg
from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
from neuralrecon_w_tpu_torch.models.neuconw import init_field
from neuralrecon_w_tpu_torch.training.step import make_render_fn
from neuralrecon_w_tpu_torch.training.validation import render_image

torch.set_num_threads(1)
wh = (8, 6)
scene, sfm_host, fine_host, frames = cs.make_scene("cpu", fine_level=5, sfm_voxel=0.2, wh=wh,
                                                   n_points=2000)
assert len(frames) == cs.FRAMES and frames[0].shape == (48, 10)
assert len(sfm_host.coords) > 0 and len(fine_host.coords) > 0
cfg = load_cfg(cs.CONFIG)
n = cfg.NEUCONW
n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
n.SDF_CONFIG.skip_in = (2,)
n.COLOR_CONFIG.d_feature, n.N_VOCAB = 64, 4
fc = field_config_from_cfg(cfg)
model = init_field(fc, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
sfm, fine = device_grid_from_host(sfm_host, "cpu"), device_grid_from_host(fine_host, "cpu")
rc = render_config_from_cfg(cfg, sfm_level=sfm_host.level, fine_level=fine_host.level,
                            nerf_far_override=True)
outs = [render_image(make_render_fn(fc, rc), model, scene, frames[0], np.zeros(48, np.int64),
                     np.zeros(48, np.int64), wh, 32, fine, sfm)]
assert cs.check_frames(outs, frames[:1], "steady", wh) == []
assert cs.path_check(model, fc, rc, scene, frames[1], fine, sfm, "steady") == []
# the fused field and background: the served chunk held to the default mode's
fused = cs.train_config(cfg, "pallas_field")
assert (fused.grad_mode, fused.bg_mode) == ("pallas_field", "pallas")
assert cs.path_check(model, fused, rc, scene, frames[1], fine, sfm, "steady fused", ref_fc=fc) == []
# the debug trace on the frame's first rays, its PLYs read back
import os
import tempfile
out = tempfile.mkdtemp()
assert cs.trace_render_check(model, fc, rc, scene, frames[1], fine, sfm, fine_host, out, 32) == []
assert sorted(os.listdir(out)) == ["trace_depth.ply", "trace_grid.ply", "trace_weights.ply"]
assert "jax" not in sys.modules and "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    proc = run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_chip_smoke_extraction_without_jax_package(tmp_path):
    """The extraction phase at a tiny width on the CPU, the kernels' plain
    versions standing in: SFM points on the field's zero set, the workspace
    and checkpoint, extract_mesh_cli at level 6 with vertex colours, the
    mesh and sweep checks all passing, and no JAX."""
    code = f"""
import sys
import torch
import chip_smoke as cs
from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg
from neuralrecon_w_tpu_torch.models.neuconw import init_field

torch.set_num_threads(1)
root = {str(tmp_path)!r}
extra = {{"NEUCONW": {{"SDF_CONFIG": {{"d_hidden": 64, "d_out": 65, "n_layers": 4, "skip_in": [2]}},
                     "COLOR_CONFIG": {{"d_feature": 64, "d_hidden": 32, "n_layers": 2}},
                     "N_VOCAB": 4}}}}
fc = field_config_from_cfg(load_cfg(cs.write_cfg(root + "/c.yaml", root, extra)))
model = init_field(fc, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
launches, fails = cs.extraction_phase(model, fc, root, n_points=3000, level=6, extra_cfg=extra,
                                      sfm_voxel=0.1875)
assert fails == [], fails
assert set(launches) == {{"sdf_mlp", "field_fwd"}}
assert "jax" not in sys.modules and "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    proc = run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "mesh: " in out and "vertex colours at " in out and out.strip().endswith("ok")


def test_chip_smoke_kernel_bounds():
    """The bounds of kernel 5's and kernel 6's ports at the path's shapes:
    every entry bound by operations at the brandenburg width, with bf16 ~6x
    below f32 (989 against 165 TFLOP/s, an f32 product reckoned at three
    TF32 ones), and linear in the points."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg
    from neuralrecon_w_tpu_torch.ops import field_train as ft
    from neuralrecon_w_tpu_torch.ops import nerf_bg_fused as bgf
    from neuralrecon_w_tpu_torch.models.neuconw import init_field

    fc = field_config_from_cfg(load_cfg(cs.CONFIG))
    model = init_field(fc, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
    wb = [t.detach() for t in ft.field_weights(model)]
    layers = bgf.bg_layers(model.nerf, True)
    bounds = {}
    for act in ("float32", "bfloat16"):
        pack = ft.pack_field_tensors(ft.field_spec(model, fc._replace(act_dtype=act)), wb)
        pk = bgf.pack_bg_weights([m.weight for m in layers], [m.bias for m in layers], act)
        bounds[act] = (cs.field_train_bound(pack, 245760), cs.bg_bound(pk, 90112, fc.n_a),
                       cs.field_train_bound(pack, 2 * 245760))
    for act, (field, bg, double) in bounds.items():
        assert set(field) == {"field_fwd", "field_bwd", "dw_reduce"}
        assert set(bg) == {"nerf_bg_fwd", "nerf_bg_bwd", "dw_reduce"}
        for b in (field["field_fwd"], field["field_bwd"], bg["nerf_bg_fwd"], bg["nerf_bg_bwd"]):
            assert b["bound_by"] == "operations" and b["bound_ms"] > 0
        # the backward recomputes the forward and runs its transpose
        assert field["field_bwd"]["bound_ms"] == pytest.approx(2 * field["field_fwd"]["bound_ms"])
        assert bg["nerf_bg_bwd"]["bound_ms"] == pytest.approx(2 * bg["nerf_bg_fwd"]["bound_ms"])
        # K9's floor in bytes: the 5,879 f32 row values a point it leaves for K5
        assert bg["nerf_bg_bwd"]["rows_floor_ms"] == pytest.approx(
            90112 * 4 * 5879 / cs.PEAK_BYTES * 1e3)
        assert double["field_bwd"]["bound_ms"] == pytest.approx(2 * field["field_bwd"]["bound_ms"],
                                                                rel=1e-3)
    assert cs.PEAK_BF16 / cs.PEAK_F32 == pytest.approx(989 / 165, rel=1e-3)
    for i in range(2):
        for k in bounds["float32"][i]:
            assert bounds["float32"][i][k]["bound_ms"] > 5.99 * bounds["bfloat16"][i][k]["bound_ms"] \
                or bounds["bfloat16"][i][k]["bound_by"] == "bytes"


def test_chip_smoke_training_without_jax_package():
    """The training phases at a tiny width on the CPU, the kernels' plain
    versions standing in: the ring-camera ray cache through the port's
    RayPool, steps in the four modes ('pallas', 'vjp', 'pallas_field' with
    FUSED_BG, 'fwd'), the parity of one step of each other mode, and no
    JAX."""
    code = """
import sys
import numpy as np
import torch
import chip_smoke as cs
from neuralrecon_w_tpu_torch.config import load_cfg
from neuralrecon_w_tpu_torch.datasets.cache import RayPool
from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
from neuralrecon_w_tpu_torch.training.schedule import make_optimizer
from neuralrecon_w_tpu_torch.training.step import init_state

torch.set_num_threads(1)
cs.TRAIN_BATCH = 48
rows, rgbs = cs.training_rays(n_cams=2, wh=(12, 8))
assert rows.shape == (192, 12) and rgbs.shape == (192, 3)
assert (rows[:, 9] == cs.LABEL_SKY).any() and (rows[:, 11] > 0).any()
assert np.all(rows[:, 6] < rows[:, 7]) and np.all(rows[:, 6] > 0)
cfg = load_cfg(cs.CONFIG)
n = cfg.NEUCONW
n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
n.SDF_CONFIG.skip_in = (2,)
n.COLOR_CONFIG.d_feature, n.COLOR_CONFIG.d_hidden, n.COLOR_CONFIG.n_layers = 64, 32, 2
n.N_VOCAB = 4
pool = RayPool(rows, rgbs, seed=int(cfg.TRAINER.SEED))
spec, _ = make_optimizer(cfg, cs.TRAIN_BATCH)
state = init_state(cs.train_config(cfg, "pallas"), spec, torch.Generator().manual_seed(0),
                   "cpu")
scene, _, fine_host, _ = cs.make_scene("cpu", fine_level=5, sfm_voxel=0.2, wh=(4, 3),
                                       n_points=2000)
before = [p.detach().clone() for p in state.model.parameters()]
rps, aux, launches, fails = cs.training_phase(cfg, state, scene, pool, None, -1, "warm-up",
                                              n_timed=2)
fine = device_grid_from_host(fine_host, "cpu")
rps, aux, launches, f2 = cs.training_phase(cfg, state, scene, pool, fine, fine_host.level,
                                           "steady", n_timed=2)
assert fails == [] and f2 == [], fails + f2
# CPU tensors take the plain versions: no mode launches a kernel
assert set(launches) == set(cs.MODE_KERNELS) and set(launches["pallas"]) == set(
    cs.launch_counters())
assert all(v == 0 for m in launches.values() for v in m.values()), launches
assert state.step == 18 and set(rps) == {"pallas", "vjp", "pallas_field", "fwd"}
assert cs.train_config(cfg, "pallas_field").bg_mode == "pallas"
assert cs.train_config(cfg, "pallas").bg_mode == "xla"
assert all(not torch.equal(a, b) for a, b in zip(before, state.model.parameters()))
assert cs.step_parity(cfg, state.model, scene, pool.next_batch(48), fine, fine_host.level,
                      "steady") == []
assert "jax" not in sys.modules and "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    proc = run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_chip_smoke_graph_phases_without_jax_package():
    """graph_parity in each kernel mode of GRAPH_MODES and graph_rates over
    RATE_MODES at a tiny width on the CPU, on the device pool's CPU path
    with its band cache (the scan run's plain loop standing in for the
    graph, the kernels' plain versions for the kernels): every check
    passing, no kernel launched, and no JAX."""
    code = """
import sys
import torch
import chip_smoke as cs
from neuralrecon_w_tpu_torch.config import load_cfg
from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool, RayPool
from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
from neuralrecon_w_tpu_torch.training.schedule import make_optimizer
from neuralrecon_w_tpu_torch.training.step import init_state

torch.set_num_threads(2)
rows, rgbs = cs.training_rays(n_cams=2, wh=(12, 8))
cfg = load_cfg(cs.CONFIG)
n = cfg.NEUCONW
n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
n.SDF_CONFIG.skip_in = (2,)
n.COLOR_CONFIG.d_feature, n.COLOR_CONFIG.d_hidden, n.COLOR_CONFIG.n_layers = 64, 32, 2
n.N_VOCAB = 4
pool = DeviceRayPool(RayPool(rows, rgbs, seed=0), "cpu")
spec, _ = make_optimizer(cfg, 48)
state = init_state(cs.train_config(cfg, "vjp"), spec, torch.Generator().manual_seed(0), "cpu")
scene, _, fine_host, _ = cs.make_scene("cpu", fine_level=5, sfm_voxel=0.2, wh=(4, 3),
                                       n_points=2000)
fine = device_grid_from_host(fine_host, "cpu")
pool.attach_surface(fine, fine_host.level)
fails = []
for mode in cs.GRAPH_MODES:
    out, f = cs.graph_parity(cfg, state, scene, pool, fine, fine_host.level, "steady", batch=48,
                             n_inner=2, mode=mode)
    fails += f
    # the plain loop stands in for the graph: the same steps exactly
    assert out["f32"]["param_rel_l2"] == 0.0 and out["f32"]["term_rel"] == 0.0, (mode, out)
rates, launches, f = cs.graph_rates(cfg, state, scene, pool, fine, fine_host.level, "steady",
                                    batch=48, n_inner=2)
fails += f
assert fails == [], fails
assert set(rates) == set(cs.RATE_MODES) and all(min(r["eager"], r["graph"]) > 0
                                                for r in rates.values())
assert all(r["per_step"] == {} for r in rates.values()) and not any(launches.values())
assert state.step == 0
assert "jax" not in sys.modules and "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    proc = run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    out = proc.stdout
    for mode in ("pallas", "pallas_field", "fwd"):
        assert f"graph vs eager steady {mode} f32 PERTURB 0, 2 steps" in out, mode
    # 'pallas' and 'pallas_field' run K5: three eager and two graph windows,
    # the bounds from the eager ones, the graph pair held to them
    assert out.count("the 3 eager windows' spread") == 2
    assert out.count("graph against graph (held to the same bounds)") == 2
    assert out.count("wall (eager, graph, eager, graph, eager)") == 2
    assert out.count("graph rates steady") == 5 and "0 capture, 0 replays" in out
    assert out.strip().endswith("ok")


def test_chip_smoke_check_helpers():
    """check_forward holds f32 outputs to atol / rtol and bf16 ones to
    rel-L2; check_outputs holds each output to its bound, or under the f32
    rule to twice the plain version's error; check_flips lets a mask differ
    from the reference's sign only near 0."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    g = torch.Generator().manual_seed(0)
    ref = [torch.randn(64, 8, generator=g) for _ in range(3)]
    near = [r * (1 + 1e-6) for r in ref]
    assert cs.check_forward("t", ["a", "b", "c"], near, ref, "float32") == (
        True, max(float((n - r).abs().max()) for n, r in zip(near, ref)))
    assert not cs.check_forward("t", ["a", "b", "c"], [r + 1e-3 for r in ref], ref, "float32")[0]
    assert cs.check_forward("t", ["a", "b", "c"], [r + 1e-3 for r in ref], ref, "bfloat16")[0]
    assert not cs.check_forward("t", ["a"], [ref[0] * float("nan")], ref[:1], "bfloat16")[0]
    off = [ref[0], ref[1], ref[2] * 1.1]
    assert cs.check_outputs("t", ["a", "b", "c"], near, ref, 1e-5) == []
    assert cs.check_outputs("t", ["a", "b", "c"], off, ref, 1e-5) == ["c"]
    plain = [r * (1 + 0.1) for r in ref]  # the f32 rule: within 2 x 0.1
    assert cs.check_outputs("t", ["a", "b", "c"], off, ref, 1e-5, plain) == []
    z = torch.randn(256, 16, generator=g)
    z[3, 4] = 1e-7
    masks = [z > 0, (z > 0).clone()]
    masks[1][3, 4] = ~masks[1][3, 4]
    assert cs.check_flips("t", masks, [z, z], 1e-3) == []
    masks[1][5, 6] = ~masks[1][5, 6]  # a flip far from 0 is a fault
    assert cs.check_flips("t", masks, [z, z], 1e-3) == [2]


@pytest.mark.parametrize("pairs", [1, 2])
def test_chip_smoke_reduce_library_matches_plain(pairs):
    """K5's yardstick, one PyTorch call per factor pair on the same float32
    workspace rows, adds the dW / db the plain version adds: an SDF layer's
    two pairs (``reduce_calls``' library and plain callables over several
    chunks), or one pair into a column slice of a wider dW from a row that
    starts one float in (``library_rows``, as ``dw_reduce_rows`` is called)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from neuralrecon_w_tpu_torch.ops import field_vjp_math as fvm
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    g = torch.Generator().manual_seed(0)
    if pairs == 2:
        ws = [torch.randn(64, 39, generator=g), torch.randn(48, 64, generator=g),
              torch.randn(65, 48, generator=g)]
        bs = [torch.randn(w.shape[0], generator=g) for w in ws]
        cfg = {"skip_in": (), "multires": 6, "scale": 1.0}
        old = vjp.CHUNK
        vjp.CHUNK = 100
        try:
            _, plain, library, (dWs, dbs) = cs.reduce_calls(ws, bs, cfg, "float32", 250)
            library()
            got = [t.clone() for t in dWs + dbs]
            for t in dWs + dbs:
                t.zero_()
            plain()
        finally:
            vjp.CHUNK = old
        want = dWs + dbs
        assert [t.shape for t in got] == [(64, 39), (48, 64), (65, 48), (64,), (48,), (65,)]
    else:
        rows, n_pts, n, k = 40, 37, 20, 13
        work = torch.randn(2 * rows * vjp.WMAX, generator=g)
        dW, db = torch.zeros(n, 30), torch.zeros(n)
        cs.library_rows(work, 5, rows * vjp.WMAX + 1, n, k, n_pts, torch.float32, dW[:, 7:7 + k],
                        db)
        x = work[5:5 + rows * vjp.WMAX].view(rows, vjp.WMAX)[:n_pts, :n]
        y = work[rows * vjp.WMAX + 1:].as_strided((n_pts, k), (vjp.WMAX, 1))
        assert float(dW[:, :7].abs().sum()) == 0.0 and float(dW[:, 7 + k:].abs().sum()) == 0.0
        got, want = [dW[:, 7:7 + k], db], [fvm._mm(x.t(), y, torch.float32), x.sum(dim=0)]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_chip_smoke_trainer_phase_without_jax_package(tmp_path):
    """trainer_phase at a tiny width on the CPU, the kernels' plain versions
    standing in: the port's workspace and ray cache, train_cli with two
    refreshes, saves and a validation, then the resumes in 'pallas_field'
    with FUSED_BG on the host pool (its checkpoint rendered through
    render_cli's scan and chunk dispatch) and on the device pool, and in
    'fwd', every refresh held to the plain SDF, the
    held-out view rendered for the image metrics; then the same run on
    the device pool in windows of 2 steps (the plain loop on the CPU), its
    band cache held to the plain DDA, and its resume; every check passing,
    and no JAX."""
    code = f"""
import sys
import numpy as np
import torch
import chip_smoke as cs

torch.set_num_threads(2)
cs.TRAINER_CAMS, cs.IMG_WH, cs.TRAINER_POINTS, cs.TRAIN_BATCH = 5, (24, 18), 1500, 128
cs.TRAINER_STEPS, cs.TRAINER_UPDATE, cs.TRAINER_VAL, cs.REFRESH_CHECK_PTS = 6, 2, 5, 4096
cs.TRAINER_LOG, cs.TRAINER_CAM_DIST = 1, 1.7  # the 4 x 64 init crosses near |x| 0.5
cs.POOL_SCAN_INNER = 2
extra = {{"NEUCONW": {{"SDF_CONFIG": {{"d_hidden": 64, "d_out": 65, "n_layers": 4, "skip_in": [2]}},
                     "COLOR_CONFIG": {{"d_feature": 64, "d_hidden": 32, "n_layers": 2}},
                     "N_VOCAB": 8}}}}
launches, fails = cs.trainer_phase({str(tmp_path)!r}, "cpu", extra, sfm_voxel=0.1875,
                                   train_voxel=0.05, fine_level=6)
assert fails == [], fails
assert set(launches) == {{"trainer", "render_scan", "render_chunk", "resume",
                         "render_pallas_field_scan", "render_pallas_field_chunk", "resume_pool",
                         "resume_pool_graph", "resume_fwd", "resume_fwd_graph", "device_pool",
                         "device_pool_resume"}}
# the device-pool resumes' windows run the plain loop on the CPU: no graph
assert not any(launches["resume_pool_graph"].values()) and not any(
    launches["resume_fwd_graph"].values())
pred, gt = cs.held_out_view_pair({str(tmp_path)!r}, "cpu")
assert pred.shape == gt.shape == (1, 18, 24, 3) and pred.dtype == gt.dtype == np.float32
assert "jax" not in sys.modules and "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    proc = run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    out = proc.stdout
    assert "trainer refresh at step 2" in out and "train_cli (the CPU): warm-up" in out
    assert "band cache at step 2:" in out and "equal to the plain DDA on every row True" in out
    assert "eager 2-step run: 0 capture(s), 0 replays" in out
    assert "host pool against device pool + graph" in out
    assert "render_cli scan vs chunk PNGs: max|diff| 0 levels -> equal" in out
    assert "render_cli pallas_field_scan vs chunk PNGs: max|diff| 0 levels -> equal" in out
    assert out.strip().endswith("ok")


def test_chip_smoke_serving_graph_phase_without_jax_package():
    """serving_graph_phase at a tiny width on the CPU: the frames in turns
    eager / scan render / scan render / eager (the scan render's plain loop
    on the CPU), every scan frame equal to the eager frame, both phases, and
    no JAX."""
    code = """
import sys
import torch
import chip_smoke as cs
from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg, render_config_from_cfg
from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
from neuralrecon_w_tpu_torch.models.neuconw import init_field

torch.set_num_threads(2)
wh = (12, 8)
cs.CHUNK = 40  # 96 rays: 3 chunks, the last padded
scene, sfm_host, fine_host, frames = cs.make_scene("cpu", fine_level=5, sfm_voxel=0.2, wh=wh,
                                                   n_points=2000)
cfg = load_cfg(cs.CONFIG)
n = cfg.NEUCONW
n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
n.SDF_CONFIG.skip_in = (2,)
n.COLOR_CONFIG.d_feature, n.N_VOCAB = 64, 4
fc = field_config_from_cfg(cfg)
model = init_field(fc, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
sfm, fine = device_grid_from_host(sfm_host, "cpu"), device_grid_from_host(fine_host, "cpu")
for level, fg in ((-1, None), (fine_host.level, fine)):
    rc = render_config_from_cfg(cfg, sfm_level=sfm_host.level, fine_level=level,
                                nerf_far_override=True)
    rps, launches, fails = cs.serving_graph_phase(model, fc, rc, scene, frames, fg, sfm, "p",
                                                  wh=wh)
    assert fails == [], fails
    assert set(rps) == {"eager", "graph"} and min(rps.values()) > 0 and launches == {}
assert "jax" not in sys.modules and "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    proc = run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    out = proc.stdout
    assert out.count("-> bit for bit") == 2 and "0 capture, 0 replays (3 a frame)" in out
    assert out.strip().endswith("ok")


def test_chip_smoke_kernel_mode_serving_graph_phase_without_jax_package():
    """serving_graph_phase in the kernel modes at a tiny width on the CPU:
    'pallas' and 'pallas_field' with FUSED_BG (the forward kernels' plain
    versions), both phases, every scan frame equal to the eager frame, and
    no JAX."""
    code = """
import sys
import torch
import chip_smoke as cs
from neuralrecon_w_tpu_torch.config import load_cfg, render_config_from_cfg
from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
from neuralrecon_w_tpu_torch.models.neuconw import init_field

torch.set_num_threads(2)
wh = (12, 8)
cs.CHUNK = 40  # 96 rays: 3 chunks, the last padded
scene, sfm_host, fine_host, frames = cs.make_scene("cpu", fine_level=5, sfm_voxel=0.2, wh=wh,
                                                   n_points=2000)
cfg = load_cfg(cs.CONFIG)
n = cfg.NEUCONW
n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
n.SDF_CONFIG.skip_in = (2,)
n.COLOR_CONFIG.d_feature, n.N_VOCAB = 64, 4
sfm, fine = device_grid_from_host(sfm_host, "cpu"), device_grid_from_host(fine_host, "cpu")
for mode, kernels in (("pallas", ("sdf_vjp_fwd",)), ("pallas_field", ("field_fwd", "nerf_bg_fwd"))):
    fc = cs.train_config(cfg, mode)
    assert cs.serving_kernels(fc) == kernels
    model = init_field(fc, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
    for level, fg in ((-1, None), (fine_host.level, fine)):
        rc = render_config_from_cfg(cfg, sfm_level=sfm_host.level, fine_level=level,
                                    nerf_far_override=True)
        rps, launches, fails = cs.serving_graph_phase(model, fc, rc, scene, frames, fg, sfm,
                                                      mode, wh=wh)
        assert fails == [], fails
        assert set(rps) == {"eager", "graph"} and min(rps.values()) > 0 and launches == {}
assert "jax" not in sys.modules and "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    proc = run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    out = proc.stdout
    assert out.count("-> bit for bit") == 4 and "0 capture, 0 replays (3 a frame)" in out
    assert out.strip().endswith("ok")


def test_chip_smoke_reproj_filter_phase_without_jax_package(tmp_path):
    """reproj_filter_phase on the CPU at a tiny width, after the extraction
    phase's mesh (level 6): ring views written into the workspace, the
    cloud voxelised into a level-9 two-level grid, K12's plain version
    against itself and against the flat DDA at level 9, reproj_filter_cli in
    point-cloud mode, its keep mask on 4 views against the plain DDA's, mesh
    mode, the rasterisers; every check passing, and no JAX."""
    code = f"""
import glob
import sys
import torch
import chip_smoke as cs
from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg
from neuralrecon_w_tpu_torch.models.neuconw import init_field

torch.set_num_threads(2)
root = {str(tmp_path)!r}
extra = {{"NEUCONW": {{"SDF_CONFIG": {{"d_hidden": 64, "d_out": 65, "n_layers": 4, "skip_in": [2]}},
                     "COLOR_CONFIG": {{"d_feature": 64, "d_hidden": 32, "n_layers": 2}},
                     "N_VOCAB": 4}}}}
fc = field_config_from_cfg(load_cfg(cs.write_cfg(root + "/c.yaml", root, extra)))
model = init_field(fc, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
_, fails = cs.extraction_phase(model, fc, root, n_points=3000, level=6, extra_cfg=extra,
                               sfm_voxel=0.1875)
assert fails == [], fails
cs.REPROJ_RASTER_FACES, cs.REPROJ_MESH_VIEWS, cs.REPROJ_WORKERS = 5000, 4, 2
(ply,) = glob.glob(root + "/results/*.ply")
entry, launches, fails = cs.reproj_filter_phase(root, ply, level=9, n_cams=6, wh=(24, 18),
                                                shell_points=20000)
assert fails == [], fails
assert entry["level"] == 9 and entry["max_abs_err"] == 0.0 and entry["bound_ms"] > 0
assert entry["hier_bytes"] < entry["flat_bytes"] and 0 < entry["filter"]["kept"]
assert set(launches) >= {{"dda_hier", "dda"}}
assert "jax" not in sys.modules and "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    proc = run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    out = proc.stdout
    assert "reproj_filter_cli point-cloud mode (the CPU): " in out
    assert "K12 vs K10 at level 9, first_only=True" in out and ", 0 else; far" in out
    assert out.count("native vs numpy rasteriser") == 2 and out.strip().endswith("ok")


def test_chip_smoke_filter_call_rays_and_k12_split(tmp_path):
    """filter_call_rays: the first n pixel rays of the first views, as
    render_hit_codes_multi packs one call; too few views raise. k12_split:
    the block / fine split, the occupied blocks entered and the distinct
    words, read off the plain version's touched counts."""
    import numpy as np

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv
    from neuralrecon_w_tpu_torch.ops.voxel_grid import VoxelGrid, _sort_coords

    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    host = VoxelGrid(6, np.zeros(3), 1.0, _sort_coords(rng.integers(16, 48, (400, 3)), 6))
    cams = cs.filter_cameras(str(tmp_path), np.zeros(3), 2.5, 3, (12, 9))
    o, d = cs.filter_call_rays(cams, host, "cpu", n=200, views=2)
    o_all, d_all = cs.cloud_rays(cams[:2], host, "cpu")
    assert o.shape == (200, 3) and torch.equal(o, o_all[:200]) and torch.equal(d, d_all[:200])
    with pytest.raises(ValueError):
        cs.filter_call_rays(cams, host, "cpu", n=1000, views=2)
    hg = rv.hier_grid_from_host(host, "cpu")
    touched = (torch.zeros(hg.meta.shape[0], dtype=torch.int32), torch.zeros_like(hg.fine))
    steps = torch.zeros(200, dtype=torch.int32)
    rv.dda_traverse_hier_plain(hg, 6, o, d, touched=touched, steps_out=steps)
    split = cs.k12_split(hg, touched, int(steps.sum()))
    assert split["block_steps"] + split["fine_steps"] == int(steps.sum())
    assert split["fine_steps"] == int(touched[1].sum()) > 0 and split["block_steps"] > 0
    assert 0 < split["blocks_entered"] <= hg.fine.numel() // 16
    assert split["meta_rows"] == int((touched[0] > 0).sum())


def test_chip_smoke_hash_points_as_a_step_encodes_them():
    """hash_kernel_phase's points: each ray's sampler points, foreground
    samples and their four taps at e = 1 / (2048 sqrt 3), in a band across
    the surface |x| = 0.5."""
    import math

    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    n = 64
    x = cs.hash_points(n, torch.device("cpu"))
    assert x.shape == (n * (cs.HASH_SAMPLER_PTS + 5 * cs.HASH_FG_PTS), 3)
    fg = x[n * cs.HASH_SAMPLER_PTS:n * (cs.HASH_SAMPLER_PTS + cs.HASH_FG_PTS)].view(n, -1, 3)
    taps = x[n * (cs.HASH_SAMPLER_PTS + cs.HASH_FG_PTS):].view(n, cs.HASH_FG_PTS, 4, 3)
    e = 1.0 / (2048 * math.sqrt(3.0))
    off = (taps - fg[:, :, None, :]) / e
    assert torch.allclose(off, torch.tensor(cs.HASH_TAPS).expand_as(off), atol=1e-2)
    assert ((x.norm(dim=-1) - 0.5).abs() <= cs.HASH_BAND + 1e-3).all()


def test_chip_smoke_kernels_line_names_every_kernel():
    """The kernels line's sources: K1-K14's wrappers by name, each a file in
    the port and the JAX function it replaces at the line it names, K12 the
    two-level DDA."""
    import re

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        text = f.read()
    vjp_src = re.search(r'vjp_src = "([\w/.]+)"', text).group(1)
    entries = {m.group(1): (m.group(2) or vjp_src, m.group(3)) for m in re.finditer(
        r'"(\w+)": \(\s*(?:"(neuralrecon_w_tpu_torch/csrc/\w+\.cu)"|vjp_src),\s*'
        r'"(neuralrecon_w_tpu/ops/\w+\.py:\d+)"\)', text)}
    sys.path.insert(0, ROOT)
    from neuralrecon_w_tpu_torch.ops import kernel_counters

    assert set(entries) == set(kernel_counters()) and "dda_hier" in entries
    for name, (src, rep) in entries.items():
        assert os.path.exists(os.path.join(ROOT, src)), name
        path, line = rep.split(":")
        with open(os.path.join(ROOT, path)) as f:
            assert len(f.read().splitlines()) >= int(line), name
    with open(os.path.join(ROOT, "neuralrecon_w_tpu/ops/ray_voxel.py")) as f:
        assert f.read().splitlines()[197].startswith("def dda_traverse_hier(")


def test_chip_smoke_prep_phase_without_jax_package(tmp_path):
    """prep_phase at a CPU size (20 views of 32x24, two turned away, 10
    test): pre_process's copy branch, the constant semantic maps, the split
    and the cache, every check passing, and no JAX."""
    code = f"""
import sys
import chip_smoke as cs

cs.PREP_TURN_EVERY = 10
secs, fails = cs.prep_phase({str(tmp_path)!r}, "cpu", n_views=20, wh=(32, 24), n_points=400)
assert fails == [], fails
assert list(secs) == ["raw layout", "pre_process", "prepare_semantic_maps",
                      "prepare_data_split", "prepare_data_cache", "load_scene_meta"]
assert "jax" not in sys.modules and "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    proc = run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    out = proc.stdout
    assert "undistort branch: copy (no colmap binary)" in out
    assert "view_selection kept 18 of 20 (turned away: 2)" in out
    assert "the cache 6144 rays of 8 views (want 6144)" in out
    assert out.strip().endswith("ok")


def test_chip_smoke_image_metrics_phase():
    """image_metrics_phase at a CPU size (LPIPS at width 0.125, a batch of 2
    at 64x48): float32 on the CPU within its bounds of float64; and an LPIPS
    1e-3 off fails."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    torch.set_num_threads(2)
    pred, gt = cs.metric_images(2, (64, 48))
    assert pred.shape == gt.shape == (2, 48, 64, 3) and 0 <= pred.min() and gt.max() <= 1
    assert cs.image_metrics_phase({"batch": (pred, gt)}, "cpu", width_mult=0.125) == []
    from unittest import mock

    from neuralrecon_w_tpu_torch.training import lpips

    real = lpips.lpips
    with mock.patch.object(lpips, "lpips", lambda m, p, g: real(m, p, g) * (
            1 + 1e-3 * (next(m.parameters()).dtype == torch.float32))):
        fails = cs.image_metrics_phase({"batch": (pred, gt)}, "cpu", width_mult=0.125)
    assert fails and "lpips_vgg" in fails[0] and "lpips_alex" in fails[0]


def test_chip_smoke_multi_rank_phase_without_jax_package(tmp_path):
    """multi_rank_phase at a tiny width on the CPU (gloo for the world-1
    group and the two ranks, the kernels' plain versions): from a 3-step
    train_cli checkpoint, the world-1 steps and sweep bit for bit those
    without a group, two spawned ranks in lockstep through a refresh,
    saves, a split validation and a resume, rank 0 alone writing, the
    reduced gradient within its bound of one rank's on a batch whose halves
    differ in masked rays; every check passing, and no JAX in the script
    or its ranks."""
    code = f"""
import os
import sys
import torch
import chip_smoke as cs

torch.set_num_threads(2)
os.environ["OMP_NUM_THREADS"] = "2"
cs.TRAINER_CAMS, cs.IMG_WH, cs.TRAINER_POINTS = 5, (24, 18), 1500
cs.MULTI_BATCH, cs.MULTI_TIMED, cs.MULTI_REDUCE_REPS = 128, 1, 2
extra = {{"NEUCONW": {{"SDF_CONFIG": {{"d_hidden": 64, "d_out": 65, "n_layers": 4, "skip_in": [2]}},
                     "COLOR_CONFIG": {{"d_feature": 64, "d_hidden": 32, "n_layers": 2}},
                     "N_VOCAB": 8}}}}
root = {str(tmp_path)!r}
cs.cli_workspace(root, "cpu", cs.TRAINER_CAMS + 1, cs.IMG_WH, cs.TRAINER_POINTS, 1.7, 64, 0.1875)
cfg = cs.write_cfg(os.path.join(root, "train.yaml"), root, cs.merged(
    {{"NEUCONW": {{"TRAIN_VOXEL_SIZE": 0.05, "UPDATE_FREQ": 3}},
     "TRAINER": {{"SAVE_FREQ": 3, "VAL_FREQ": 1000.0}}, "TPU": {{"DEVICE_POOL": False}}}}, extra))
cs.train_cli(cfg, os.path.join(root, "results"), "trainer", 128, 3, "cpu")
ck = os.path.join(root, "results", "trainer", "checkpoints", "step_3.ckpt")
launches, fails = cs.multi_rank_phase(root, ck, "cpu", extra_cfg=extra, train_voxel=0.05)
assert fails == [], fails
assert set(launches) == {{"multi_rank world1", "multi_rank rank0", "multi_rank rank1"}}
assert "jax" not in sys.modules and "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    proc = run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    out = proc.stdout
    assert "with a gloo group of 1 rank and without a group: parameters equal bit for bit" in out
    assert "multi-rank run: step 9 / 9; parameters bit for bit equal on the two ranks" in out
    assert "refreshes at [7] / [7]" in out and "1 validation(s)" in out
    assert "the two gloo ranks' reduced gradients equal" in out
    assert out.strip().endswith("ok")


def test_chip_smoke_tensor_parallel_phase_without_jax_package(tmp_path):
    """tensor_parallel_phase at a tiny width on the CPU (two gloo ranks on
    a model axis of 2, the kernels' plain versions): from a 3-step
    train_cli checkpoint, 'vjp' and 'pallas' steps of the split field held
    to one rank's (loss, parameters and the first step's gradients), the
    whole leaves bit for bit on both ranks, a finite bf16 step; every check passing, and no JAX in the script or its
    ranks."""
    code = f"""
import os
import sys
import torch
import chip_smoke as cs

torch.set_num_threads(2)
os.environ["OMP_NUM_THREADS"] = "2"
cs.TRAINER_CAMS, cs.IMG_WH, cs.TRAINER_POINTS = 5, (24, 18), 1500
cs.TP_BATCH, cs.TP_WIRE_MB = 128, 8
extra = {{"NEUCONW": {{"SDF_CONFIG": {{"d_hidden": 64, "d_out": 65, "n_layers": 4, "skip_in": [2]}},
                     "COLOR_CONFIG": {{"d_feature": 64, "d_hidden": 32, "n_layers": 2}},
                     "N_VOCAB": 8}}}}
root = {str(tmp_path)!r}
cs.cli_workspace(root, "cpu", cs.TRAINER_CAMS + 1, cs.IMG_WH, cs.TRAINER_POINTS, 1.7, 64, 0.1875)
cfg = cs.write_cfg(os.path.join(root, "train.yaml"), root, cs.merged(
    {{"NEUCONW": {{"TRAIN_VOXEL_SIZE": 0.05}}, "TRAINER": {{"SAVE_FREQ": 3, "VAL_FREQ": 1000.0}},
     "TPU": {{"DEVICE_POOL": False}}}}, extra))
cs.train_cli(cfg, os.path.join(root, "results"), "trainer", 128, 3, "cpu")
ck = os.path.join(root, "results", "trainer", "checkpoints", "step_3.ckpt")
launches, fails = cs.tensor_parallel_phase(root, ck, "cpu", extra_cfg=extra, train_voxel=0.05)
assert fails == [], fails
assert set(launches) == {{"tensor_parallel rank0", "tensor_parallel rank1"}}
assert "jax" not in sys.modules and "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    proc = run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    out = proc.stdout
    assert "field_param_specs over 2 model ranks:" in out
    assert "row (neuconw.sdf_net.lin1.weight_v, neuconw.sdf_net.lin4.weight_v" in out
    for mode in ("vjp", "pallas"):
        assert f"tensor-parallel {mode}: 2 f32 steps" in out and "-> ok" in out
    assert "bit for bit equal on the two ranks" in out and "on the 128 rays" in out
    assert "the first step's gathered gradients worst" in out
    assert "finite;" in out and "GB/s), all-gather of 8 MB" in out
    assert out.strip().endswith("ok")


def test_chip_smoke_optimizer_phase_without_jax_package(tmp_path):
    """optimizer_phase at a tiny width on the CPU (the kernels' plain
    versions, the plain loop in place of a graph): from a 5-step train_cli
    checkpoint's parameters and fine grid, for SGD and RAdam an 8-step
    window held to the plain loop by graph_parity, a train_cli run saved at
    update 5 and resumed, its optimiser state restored bit for bit, then
    the three optimisers' windows timed in turns; every check passing, and
    no JAX."""
    code = f"""
import os
import sys
import torch
import chip_smoke as cs

torch.set_num_threads(2)
cs.TRAINER_CAMS, cs.IMG_WH, cs.TRAINER_POINTS, cs.TRAIN_BATCH = 5, (24, 18), 1500, 128
cs.OPT_RATE_INNER = 2
extra = {{"NEUCONW": {{"SDF_CONFIG": {{"d_hidden": 64, "d_out": 65, "n_layers": 4, "skip_in": [2]}},
                     "COLOR_CONFIG": {{"d_feature": 64, "d_hidden": 32, "n_layers": 2}},
                     "N_VOCAB": 8}}}}
root = {str(tmp_path)!r}
cs.cli_workspace(root, "cpu", cs.TRAINER_CAMS + 1, cs.IMG_WH, cs.TRAINER_POINTS, 1.7, 64, 0.1875)
cfg = cs.write_cfg(os.path.join(root, "train.yaml"), root, cs.merged(
    {{"NEUCONW": {{"TRAIN_VOXEL_SIZE": 0.05, "UPDATE_FREQ": 2}},
     "TRAINER": {{"SAVE_FREQ": 5, "VAL_FREQ": 1000.0}}, "TPU": {{"DEVICE_POOL": False}}}}, extra))
cs.train_cli(cfg, os.path.join(root, "results"), "trainer", 128, 5, "cpu")
ck = os.path.join(root, "results", "trainer", "checkpoints", "step_5.ckpt")
launches, fails = cs.optimizer_phase(root, ck, "cpu", extra_cfg=extra, train_voxel=0.05)
assert fails == [], fails
assert set(launches) == {{"optimizer parity", "optimizer parity_graph", "optimizer rates",
                         "optimizer rates_graph", "optimizer sgd", "optimizer sgd_graph",
                         "optimizer sgd_resume", "optimizer sgd_resume_graph", "optimizer radam",
                         "optimizer radam_graph", "optimizer radam_resume",
                         "optimizer radam_resume_graph"}}
assert "jax" not in sys.modules and "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    proc = run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    out = proc.stdout
    for name in ("sgd", "radam"):
        assert f"graph vs eager optimizer {name} vjp f32 PERTURB 0, 8 steps" in out
        assert (f"optimizer {name}: graph vs eager, steady vjp, 8 steps from a fresh state "
                "(0 capture, 0 replays, update counts (8, 8)): graph_parity's bounds held; "
                "the parameters' change rel-L2 0.00e+00 of eager's") in out
        assert f"optimizer {name}: saved at step 10, update 5 ({name}); the resumed Trainer's " \
               "state equals the saved one bit for bit" in out
        for tag, at in (("", "5 to 10, update count 5"), ("_resume", "10 to 15, update count 10")):
            assert (f"optimizer {name}{tag}: train_cli 5 steps from step {at}; a 5-step run: "
                    "0 capture(s), 0 replays") in out
    assert "-> ok" in out and "-> FAIL" not in out
    assert "ms a step over 2-step eager windows in turns (adam, sgd, radam, radam, sgd, adam)" \
        in out
    assert out.strip().endswith("ok")
