"""The port's span system (``neuralrecon_w_tpu_torch/tracing.py``): the
table, the host ranges a plain CPU training step opens and how they nest,
``span_ms`` after a step, the served frame's host spans, and the
Trainer's log of them. On the card (``cuda``-marked, skipped without
one): a captured training dispatch and a captured served frame leave a
begin / end marker pair per device span and replay in the profiler's
device trace."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neuralrecon_w_tpu_torch import tracing  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "config", "train_brandenburg_gate_tpu.yaml")
REMOVED = ("render.sfm_near_far", "render.surface_band", "train.all_reduce_counts",
           "train.sync_replicated_grads", "train.all_reduce_grads")
STEP_SPANS = {"train.render_loss", "render.importance", "render.background",
              "render.foreground", "train.backward", "train.optimizer"}
RENDER_SPANS = {"render.importance", "render.background", "render.foreground"}

torch.set_num_threads(1)


def small_cfg():
    """The brandenburg_gate_tpu operating point at a narrow width, in f32."""
    from neuralrecon_w_tpu_torch.config import load_cfg

    cfg = load_cfg(CONFIG)
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
    n.SDF_CONFIG.skip_in = (2,)
    n.COLOR_CONFIG.d_feature, n.COLOR_CONFIG.d_hidden, n.COLOR_CONFIG.n_layers = 64, 32, 2
    n.N_VOCAB = 16
    cfg.TPU.FIELD_DTYPE = "float32"
    return cfg


def slab_grid():
    """A slab of occupied cells across the cube's centre (test_torch_render's)."""
    from neuralrecon_w_tpu_torch.ops.voxel_grid import VoxelGrid

    cc = np.stack(np.meshgrid(np.arange(5, 11), np.arange(5, 11), [8, 9], indexing="ij"),
                  -1).reshape(-1, 3)
    return VoxelGrid(4, np.zeros(3), 2.0, cc.astype(np.int32))


def make_rays(r, seed=0):
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.0, -3.0]]), (r, 1))
    d = rng.standard_normal((r, 3)) * 0.3 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((r, 1), 1.0), np.full((r, 1), 5.0),
                           np.full((r, 1), 3.0), (rng.random((r, 1)) > 0.5)], -1)
    return (rays.astype(np.float32), rng.integers(0, 16, r).astype(np.int32),
            np.zeros(r, np.int32))


def cpu_step():
    """(step_fn, state, scene, batch, fine grid) of one plain CPU step."""
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, render_config_from_cfg
    from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
    from neuralrecon_w_tpu_torch.rendering.renderer import SceneInfo
    from neuralrecon_w_tpu_torch.training.losses import loss_config_from_cfg
    from neuralrecon_w_tpu_torch.training.schedule import make_optimizer
    from neuralrecon_w_tpu_torch.training.step import init_state, make_train_step

    cfg = small_cfg()
    fc = field_config_from_cfg(cfg)
    host = slab_grid()
    rc = render_config_from_cfg(cfg, sfm_level=host.level, fine_level=host.level)
    assert rc.render_bg and rc.n_outside > 0 and rc.n_importance > 0
    step = make_train_step(fc, rc, loss_config_from_cfg(cfg), 100)
    spec, _ = make_optimizer(cfg, 32)
    state = init_state(fc, spec, torch.Generator().manual_seed(0), "cpu")
    rays, ts, labels = make_rays(32)
    batch = {"rays": rays, "ts": ts, "labels": labels,
             "rgbs": np.random.default_rng(1).random((32, 3)).astype(np.float32)}
    scene = SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4))
    return step, state, scene, batch, device_grid_from_host(host, "cpu")


def host_ranges(prof, names):
    """[(name, start us, end us)] of the profile's host ranges named in ``names``."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name in names and e.device_type == torch.autograd.DeviceType.CPU]


def test_span_table():
    """Names and ids unique, each parent in the table, kinds device / host,
    and every id below the marker kernel's SPAN_IDS."""
    names = [s.name for s in tracing.SPANS]
    ids = [s.id for s in tracing.SPANS]
    assert len(set(names)) == len(names) and len(set(ids)) == len(ids)
    assert all(s.parent is None or s.parent in tracing.BY_NAME for s in tracing.SPANS)
    assert {s.kind for s in tracing.SPANS} == {tracing.DEVICE, tracing.HOST}
    with open(os.path.join(ROOT, "neuralrecon_w_tpu_torch", "csrc", "span_mark.cu")) as f:
        span_ids = int(re.search(r"constexpr int SPAN_IDS = (\d+);", f.read()).group(1))
    assert 0 <= min(ids) and max(ids) < span_ids
    assert not set(REMOVED) & set(names)


def test_cpu_step_spans_nest_as_declared():
    """A plain CPU step under torch.profiler opens exactly the device spans
    a step reaches, once each, every child inside its parent; the removed
    spans are gone; span_ms gives each a positive time, train.render_loss
    at least the sum of its render.* children."""
    from torch.profiler import ProfilerActivity, profile

    step, state, scene, batch, fine = cpu_step()
    step(state, scene, batch, fine)  # warm
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, scene, batch, fine)
    names = {s.name for s in tracing.SPANS} | set(REMOVED)
    got = host_ranges(prof, names)
    assert sorted(n for n, _, _ in got) == sorted(STEP_SPANS)
    at = {n: (a, b) for n, a, b in got}
    for name, (a, b) in at.items():
        parent = tracing.BY_NAME[name].parent
        if parent is not None:
            assert at[parent][0] <= a <= b <= at[parent][1], name
    # the step's phases in order
    order = sorted(("train.render_loss", "train.backward", "train.optimizer"), key=lambda n: at[n])
    assert order == ["train.render_loss", "train.backward", "train.optimizer"]
    ms = tracing.span_ms()
    assert set(ms) == STEP_SPANS and all(v > 0 for v in ms.values()), ms
    assert ms["train.render_loss"] >= sum(ms[n] for n in RENDER_SPANS)


def test_scan_render_frame_host_spans():
    """render_image with a CPU ScanRender opens serve.frame_in and
    serve.frame_out once each, around the render's spans, and span_ms
    times both."""
    from torch.profiler import ProfilerActivity, profile

    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, render_config_from_cfg
    from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
    from neuralrecon_w_tpu_torch.rendering.renderer import SceneInfo
    from neuralrecon_w_tpu_torch.tools.convert import init_field
    from neuralrecon_w_tpu_torch.training.step import make_render_fn, make_scan_render_fn
    from neuralrecon_w_tpu_torch.training.validation import render_image

    cfg = small_cfg()
    fc = field_config_from_cfg(cfg)
    host = slab_grid()
    rc = render_config_from_cfg(cfg, sfm_level=host.level, fine_level=host.level)
    model = init_field(fc, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
    grid = device_grid_from_host(host, "cpu")
    scene = SceneInfo(torch.zeros(3), torch.tensor(2.0), torch.eye(4))
    rays, ts, labels = make_rays(20, seed=5)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img = render_image(make_render_fn(fc, rc), model, scene, rays, ts, labels, (5, 4),
                           chunk=8, fine_grid=grid, sfm_grid=grid,
                           scan_render=make_scan_render_fn(fc, rc, 8))
    assert img["color"].shape == (4, 5, 3)
    got = host_ranges(prof, {"serve.frame_in", "serve.frame_out"} | RENDER_SPANS)
    frame = {n: (a, b) for n, a, b in got if n.startswith("serve.")}
    assert sorted(frame) == ["serve.frame_in", "serve.frame_out"]
    renders = [(a, b) for n, a, b in got if n in RENDER_SPANS]
    assert len(renders) == 3 * len(RENDER_SPANS)  # 3 chunks of 8
    assert frame["serve.frame_in"][1] <= min(a for a, _ in renders)
    assert max(b for _, b in renders) <= frame["serve.frame_out"][0]
    ms = tracing.span_ms()
    assert ms["serve.frame_in"] > 0 and ms["serve.frame_out"] > 0


def test_trainer_logs_span_times(tmp_path):
    """A tiny Trainer.fit logs time/<span>_ms at its log point for every
    span its step reached."""
    import json

    import yaml

    from neuralrecon_w_tpu_torch.config import load_cfg
    from neuralrecon_w_tpu_torch.testing import make_synthetic_scene
    from neuralrecon_w_tpu_torch.tools.prepare_data import prepare_data_cache
    from neuralrecon_w_tpu_torch.training.loop import Trainer, TrainerConfig

    root = str(tmp_path / "scene")
    make_synthetic_scene(root, n_images=6, n_test=1, img_wh=(16, 12), n_points=200)
    prepare_data_cache.main(["--root_dir", root, "--split_to_chunks", "2", "--cache_type", "npz",
                             "--device", "cpu"])
    cfg_path = str(tmp_path / "c.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"NEUCONW": {"SDF_CONFIG": {"d_hidden": 64, "d_out": 65, "n_layers": 4,
                                                   "skip_in": [2]},
                                    "COLOR_CONFIG": {"d_feature": 64, "d_hidden": 32,
                                                     "n_layers": 2},
                                    "N_SAMPLES": 8, "N_IMPORTANCE": 8, "UP_SAMPLE_STEP": 2,
                                    "N_OUTSIDE": 2, "N_VOCAB": 8},
                        "DATASET": {"ROOT_DIR": root},
                        "TRAINER": {"SAVE_FREQ": 1000, "VAL_FREQ": 1000.0}}, f)
    tracing.reset()
    tr = Trainer(load_cfg(cfg_path), TrainerConfig(batch_size=16, num_epochs=1, log_every=2,
                                                   save_dir=str(tmp_path / "runs")),
                 device="cpu")
    tr.fit(max_steps=2)
    tr.logger.close()
    with open(tr.logger.path) as f:
        logged = [json.loads(line) for line in f]
    at = [r for r in logged if r.get("step") == 2 and "loss" in r]
    assert len(at) == 1
    times = {k: v for k, v in at[0].items() if k.startswith("time/")}
    assert set(times) == {f"time/{n}_ms" for n in STEP_SPANS}, sorted(times)
    assert all(v > 0 for v in times.values())


# ------------------------------- the card -------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the marker kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def device_markers(prof) -> list:
    """(span name, end) of each marker kernel in the profile's device trace, in order."""
    by_id = {s.id: s.name for s in tracing.SPANS}
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"span_mark_kernel<\s*(\d+)[uU]?\s*,\s*(\d+)[uU]?\s*>", e.name)
        if m:
            out.append((by_id[int(m.group(1))], int(m.group(2))))
    return out


def assert_pairs(marks, spans, n):
    """n begin / end pairs of each span, each begin closed by its end."""
    for name in spans:
        seq = [end for s, end in marks if s == name]
        assert seq == [0, 1] * n, (name, seq)
    assert {s for s, _ in marks} == set(spans)


@pytest.mark.cuda
def test_captured_dispatch_replays_its_markers(dev):
    """A captured ScanRun dispatch of N replays shows N begin / end marker
    pairs of every device span a step reaches in the profiler's device
    trace; span_ms is positive afterwards, without a profiler."""
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from neuralrecon_w_tpu_torch.config import render_config_from_cfg
    from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool, RayPool
    from neuralrecon_w_tpu_torch.training.schedule import make_optimizer
    from neuralrecon_w_tpu_torch.training.step import GRAPH_WARMUP, init_state

    cfg = small_cfg()
    rows, rgbs = cs.training_rays(n_cams=4, wh=(40, 30))
    pool = DeviceRayPool(RayPool(rows, rgbs, seed=0), dev)
    spec, _ = make_optimizer(cfg, 512)
    fc = cs.train_config(cfg, "vjp")
    state = init_state(fc, spec, torch.Generator().manual_seed(0), dev)
    scene, _, _, _ = cs.make_scene(dev, fine_level=7, wh=(8, 6), n_points=5000)
    rcfg = render_config_from_cfg(cfg, sfm_level=-1, fine_level=-1, nerf_far_override=False)
    n = 3
    run = cs.scan_run(cfg, fc, rcfg, 512, n, True)
    perm, start = pool.take_scan_window(512, n)
    state, _ = run(state, scene, pool.data, None, None, perm, start)  # the capture
    assert run.per_step_launches and "span_mark" not in run.per_step_launches
    perm, start = pool.take_scan_window(512, n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, aux = run(state, scene, pool.data, None, None, perm, start)
        torch.cuda.synchronize()
    assert run.captures == 1 and run.replays == 2 * n - GRAPH_WARMUP
    assert_pairs(device_markers(prof), STEP_SPANS, n)
    ms = tracing.span_ms()
    assert all(ms[s] > 0 for s in STEP_SPANS), ms
    assert ms["train.render_loss"] >= sum(ms[s] for s in RENDER_SPANS)
    assert ms["train.inputs"] > 0
    run.release()


@pytest.mark.cuda
def test_captured_frame_replays_its_markers(dev):
    """A frame of C chunks through a captured ScanRender shows C begin / end
    marker pairs of each render.* span, and span_ms times them and the
    frame's host spans."""
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, render_config_from_cfg
    from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
    from neuralrecon_w_tpu_torch.tools.convert import init_field
    from neuralrecon_w_tpu_torch.training.step import make_render_fn, make_scan_render_fn
    from neuralrecon_w_tpu_torch.training.validation import render_image

    cfg = small_cfg()
    fc = field_config_from_cfg(cfg)
    model = init_field(fc, torch.Generator().manual_seed(0), dev).requires_grad_(False)
    wh = (48, 36)
    scene, sfm_host, fine_host, frames = cs.make_scene(dev, fine_level=7, wh=wh, n_points=5000)
    sfm, fine = device_grid_from_host(sfm_host, dev), device_grid_from_host(fine_host, dev)
    rc = render_config_from_cfg(cfg, sfm_level=sfm_host.level, fine_level=fine_host.level,
                                nerf_far_override=True)
    run = make_scan_render_fn(fc, rc, 512)
    zeros = np.zeros(len(frames[0]), np.int64)
    args = (frames[0], zeros, zeros, wh, 512, fine, sfm)
    render_image(make_render_fn(fc, rc), model, scene, *args, scan_render=run)  # the capture
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render_image(make_render_fn(fc, rc), model, scene, *args, scan_render=run)
    chunks = -(-len(frames[0]) // 512)
    assert run.captures == 1
    assert_pairs(device_markers(prof), RENDER_SPANS, chunks)
    ms = tracing.span_ms()
    assert all(ms[s] > 0 for s in RENDER_SPANS | {"serve.frame_in", "serve.frame_out"}), ms
    run.release()
