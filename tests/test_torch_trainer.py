"""PyTorch port, the training entry point: the port's Trainer against the
JAX package's on the same workspace, ray cache and cfg (tests/test_e2e.py's
fixture at batch 64, PERTURB 0, host pool, a surface refresh every 2 steps,
one validation), the port starting from the JAX initialisation carried
across; resume from JAX's state after step 2; checkpoints, --divide_lr,
val_interval and the guards."""

import json
import os

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neuralrecon_w_tpu.config import get_cfg_defaults  # noqa: E402
from neuralrecon_w_tpu.parallel.mesh import make_mesh  # noqa: E402
from neuralrecon_w_tpu.testing import make_synthetic_scene  # noqa: E402
from neuralrecon_w_tpu.tools.prepare_data.prepare_data_cache import main as cache_main  # noqa: E402
from neuralrecon_w_tpu.training import loop as jax_loop  # noqa: E402
from neuralrecon_w_tpu.training.schedule import scaled_lr as jax_scaled_lr  # noqa: E402
from neuralrecon_w_tpu_torch.config import load_cfg  # noqa: E402
from neuralrecon_w_tpu_torch.tools.convert import params_from_jax, state_from_jax  # noqa: E402
from neuralrecon_w_tpu_torch.training import loop  # noqa: E402
from neuralrecon_w_tpu_torch.training.checkpoint import (  # noqa: E402
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(2)

BATCH = 64
LOSS_RTOL = 1e-4  # every logged loss term, psnr and s_val
PSNR_ATOL = 1e-3  # the validation PSNR
# Adam moves a parameter by about lr a step whatever its gradient's size,
# so a gradient within rounding of 0 can take either sign: after 4 steps a
# parameter may differ by up to 4 * 2 * lr; all but PARAM_FRAC of them
# agree within PARAM_ATOL
PARAM_ATOL, PARAM_FRAC = 1e-5, 1e-3
# the e2e cfg's SDF_THRESHOLD 0.1 keeps every candidate at step 2 (the
# untrained SDF is negative on them all), which would not test the
# selection; at this threshold JAX's step-2 SDF keeps 50 % of the 13,376
# candidates, and none lies within 4.6e-5 of it (JAX on the CPU)
REFRESH_THRESHOLD = -0.21536
LOSS_KEYS = ("loss", "color_loss", "normal_loss", "mask_error", "sfm_depth_loss", "psnr",
             "s_val")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """tests/test_e2e.py's workspace and cfg, the ray cache written by the
    JAX package's CLI; UPDATE_FREQ 2, VAL_FREQ 4 steps, PERTURB 0, and
    SDF_THRESHOLD at REFRESH_THRESHOLD, which keeps about half the
    candidates of the refresh at step 2."""
    base = tmp_path_factory.mktemp("trainer")
    root = str(base / "sphere_scene")
    os.makedirs(root)
    make_synthetic_scene(root, n_images=6, n_test=1, img_wh=(40, 30))
    cache_main(["--root_dir", root, "--split_to_chunks", "8"])
    cfg = {
        "NEUCONW": {
            "N_SAMPLES": 8, "N_IMPORTANCE": 8, "UP_SAMPLE_STEP": 2, "N_OUTSIDE": 2,
            "BOUNDARY_SAMPLES": 2, "S_VAL_BASE": 1, "SAMPLE_RANGE": 4, "N_VOCAB": 16,
            "ANNEAL_END": 100, "UPDATE_FREQ": 2, "TRAIN_VOXEL_SIZE": 0.12,
            "SDF_THRESHOLD": REFRESH_THRESHOLD, "NEAR_FAR_OVERRIDE": True, "PERTURB": 0.0,
            "SDF_CONFIG": {"d_hidden": 64, "d_out": 65, "n_layers": 4, "skip_in": [2]},
            "COLOR_CONFIG": {"d_feature": 64, "d_hidden": 32, "n_layers": 2,
                             "head_channels": 16},
            "MESH_MASK_LIST": ["sky"], "DEPTH_LOSS": True, "LOSS": {"depth_weight": 1.0},
        },
        "DATASET": {"ROOT_DIR": root, "DATASET_NAME": "phototourism",
                    "PHOTOTOURISM": {"IMG_DOWNSCALE": 1}},
        "TRAINER": {"SAVE_FREQ": 1000, "VAL_FREQ": 4.0, "CANONICAL_LR": 1e-3,
                    "CANONICAL_BS": 512},
    }
    path = str(base / "train_sphere.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, str(base)


def jax_cfg(path):
    cfg = get_cfg_defaults()
    cfg.merge_from_file(path)
    cfg.TRAINER.LR = jax_scaled_lr(cfg, BATCH)  # as train_cli sets it
    return cfg


def port_cfg(path):
    cfg = load_cfg(path)
    cfg.TRAINER.LR = float(cfg.TRAINER.CANONICAL_LR) * BATCH / float(cfg.TRAINER.CANONICAL_BS)
    return cfg


def tcfg(module, save_dir, name, **kw):
    return module.TrainerConfig(batch_size=BATCH, num_epochs=100, test_batch_size=128,
                                exp_name=name, save_dir=save_dir, **kw)


def read_log(path):
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec.pop("step"), {}).update(rec)
    return out


def port_trainer(cfg_path, save_dir, name, np_state):
    tr = loop.Trainer(port_cfg(cfg_path), tcfg(loop, save_dir, name), device="cpu")
    tr.state, _ = state_from_jax(np_state, tr.fc, tr.opt_spec, device="cpu")
    return tr


@pytest.fixture(scope="module")
def runs(workspace):
    """The JAX Trainer: 2 steps, its state kept, 2 more steps (a refresh at
    step 2, validation at step 4). The port: the same from JAX's
    initialisation, and again from JAX's state after step 2."""
    cfg_path, base = workspace
    jtr = jax_loop.Trainer(jax_cfg(cfg_path), tcfg(jax_loop, base, "jax"), make_mesh(1))
    init = jax.device_get(jtr.state)
    jpool = jtr.load_rays()
    jtr.fit(jpool, max_steps=2)
    mid = jax.device_get(jtr.state)
    jtr.fit(jpool, max_steps=2)

    ptr = port_trainer(cfg_path, base, "port", init)
    ppool = ptr.load_rays()
    ptr.fit(ppool, max_steps=2)
    ptr.fit(ppool, max_steps=2)

    rtr = port_trainer(cfg_path, base, "resume", mid)
    rpool = rtr.load_rays()
    rpool.next_batch(BATCH)
    rpool.next_batch(BATCH)
    rtr.fit(rpool, max_steps=2)
    return {"jax": jtr, "port": ptr, "resume": rtr, "base": base,
            "final": jax.device_get(jtr.state)}


def logs(runs, name):
    return read_log(os.path.join(runs["base"], name, "logs", "metrics.jsonl"))


def assert_params_close(model, np_params):
    want = params_from_jax(np_params)
    got = {k: v.detach() for k, v in model.state_dict().items()}
    assert got.keys() == want.keys()
    diffs = np.concatenate([(got[k] - want[k]).abs().flatten().numpy() for k in want])
    lr = 1e-3 * BATCH / 512
    assert diffs.max() <= 8 * lr, diffs.max()
    assert (diffs > PARAM_ATOL).mean() <= PARAM_FRAC, (diffs > PARAM_ATOL).mean()


def test_trainer_matches_jax(runs):
    """Logged losses at steps 2 and 4 within LOSS_RTOL, the parameters after
    step 4, the refreshed grid's cells and the validation PSNR."""
    jl, pl = logs(runs, "jax"), logs(runs, "port")
    assert sorted(pl) == sorted(jl) == [2, 4]
    for step in (2, 4):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(pl[step][k], jl[step][k], rtol=LOSS_RTOL, err_msg=k)
        assert pl[step]["rays_per_sec"] > 0
    assert abs(pl[4]["val/psnr"] - jl[4]["val/psnr"]) <= PSNR_ATOL
    jtr, ptr = runs["jax"], runs["port"]
    assert int(jtr.state.step) == ptr.state.step == 4
    assert_params_close(ptr.state.model, runs["final"].params)
    jg, pg = jtr.fine_grid_host, ptr.fine_grid_host
    assert pg.level == jg.level == ptr.train_level == jtr.train_level
    np.testing.assert_array_equal(pg.origin, jg.origin)
    assert pg.scale == jg.scale
    assert set(map(tuple, pg.coords.tolist())) == set(map(tuple, np.asarray(jg.coords).tolist()))
    assert len(ptr.refreshes) == 1 and ptr.refreshes[0]["step"] == 2
    assert 0.3 < ptr.refreshes[0]["kept_frac"] < 0.7
    assert len(ptr.val_seconds) == 1
    assert os.path.exists(os.path.join(runs["base"], "port", "val", "val_4.png"))


def test_resume_from_jax_state_matches_jax(runs):
    """JAX's state after step 2 (Adam moments and count included) carried
    across continues in the port to JAX's step 4."""
    jl, rl = logs(runs, "jax"), logs(runs, "resume")
    for k in LOSS_KEYS:
        np.testing.assert_allclose(rl[4][k], jl[4][k], rtol=LOSS_RTOL, err_msg=k)
    assert runs["resume"].state.step == 4
    assert runs["resume"].state.optimizer.count == 4
    assert_params_close(runs["resume"].state.model, runs["final"].params)


def test_state_from_jax_carries_the_grid(runs):
    """The JAX fine grid comes across with the same cells in the port's
    order, and the Adam state as torch's."""
    jtr = runs["jax"]
    state, fine = state_from_jax(runs["final"], runs["port"].fc, runs["port"].opt_spec,
                                 jtr.fine_grid_host, "cpu")
    assert fine.level == jtr.fine_grid_host.level
    np.testing.assert_array_equal(fine.coords, runs["port"].fine_grid_host.coords)
    assert state.step == 4 and state.optimizer.count == 4
    assert len(state.optimizer.opt.state) == len(list(state.model.parameters()))


def test_logged_lr_is_jax_constant_lr(runs):
    """The JAX Trainer's optimiser has schedule total 0, a constant LR; the
    port logs that LR at every logged step."""
    lr = runs["jax"].lr_schedule
    assert not callable(lr)
    for rec in logs(runs, "port").values():
        if "lr" in rec:
            assert rec["lr"] == pytest.approx(float(lr), rel=1e-7)


def test_checkpoint_round_trip(runs, tmp_path):
    """The trainer's last checkpoint restores parameters, step, Adam state,
    update count and the fine grid; latest_checkpoint finds it."""
    ptr = runs["port"]
    ck = latest_checkpoint(ptr.ckpt_dir)
    assert ck == os.path.join(ptr.ckpt_dir, "step_4.ckpt")
    assert os.path.exists(os.path.join(ptr.ckpt_dir, "step_2.ckpt"))
    assert os.path.exists(os.path.join(ptr.ckpt_dir, "config_snapshot.yaml"))
    r = restore_checkpoint(ck)
    assert r["step"] == 4 and r["optimizer"]["count"] == 4
    assert "neuconw.xyz_encoding_final.weight" in r["state_dict"]  # the reference's layout
    back = loop.Trainer(ptr.cfg, tcfg(loop, str(tmp_path), "back", ckpt_path=ck), device="cpu")
    assert back.state.step == 4 and back.state.optimizer.count == 4
    for (k, a), b in zip(ptr.state.model.state_dict().items(),
                         back.state.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = ptr.state.optimizer.opt.state_dict(), back.state.optimizer.opt.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    np.testing.assert_array_equal(back.fine_grid_host.coords, ptr.fine_grid_host.coords)
    assert back.fine_grid_host.level == ptr.fine_grid_host.level
    assert torch.equal(back.fine_dgrid.occ, ptr.fine_dgrid.occ)
    assert latest_checkpoint(str(tmp_path / "nowhere")) is None


def test_divide_lr_matches_jax(workspace, runs, tmp_path):
    """train_cli --ckpt_path --divide_lr: the JAX CLI's LR, and the step
    continues from the checkpoint's (--max_steps 0 trains nothing)."""
    from neuralrecon_w_tpu.tools.train_cli import main as jax_main
    from neuralrecon_w_tpu.training import latest_checkpoint as jax_latest
    from neuralrecon_w_tpu_torch.tools.train_cli import main

    cfg_path, _ = workspace
    common = ["--cfg_path", cfg_path, "--batch_size", str(BATCH), "--num_epochs", "100",
              "--max_steps", "0", "--divide_lr", "--lr_divisor", "4"]
    jtr = jax_main(common + ["--save_dir", str(tmp_path), "--exp_name", "j", "--ckpt_path",
                             jax_latest(runs["jax"].ckpt_dir)])
    ptr = main(common + ["--save_dir", str(tmp_path), "--exp_name", "p", "--device", "cpu",
                         "--ckpt_path", latest_checkpoint(runs["port"].ckpt_dir)])
    assert ptr.lr_at(0) == pytest.approx(float(jtr.lr_schedule), rel=1e-7)
    assert ptr.lr_at(0) == pytest.approx(1e-3 * BATCH / 512 / 4, rel=1e-7)
    assert ptr.state.step == int(jtr.state.step) == 4


def test_params_only_checkpoint_restores(runs, tmp_path):
    """A parameters-only .ckpt (the reference's own layout, or save_checkpoint
    without an optimiser) restores with fresh optimiser state and no grid."""
    ptr = runs["port"]
    path = save_checkpoint(str(tmp_path / "p.ckpt"), ptr.state.model, 7)
    back = loop.Trainer(ptr.cfg, tcfg(loop, str(tmp_path), "b", ckpt_path=path), device="cpu")
    assert back.state.step == 7 and back.state.optimizer.count == 0
    assert not back.state.optimizer.opt.state
    assert back.fine_grid_host is None and back.fine_dgrid is None
    for (k, a), b in zip(ptr.state.model.state_dict().items(),
                         back.state.model.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("val_freq", [0.125, 0.5, 1.0, 1.5, 2.0, 10000.0, 0.001])
@pytest.mark.parametrize("steps_per_epoch", [1, 7, 64, 1000])
def test_val_interval_matches_jax(val_freq, steps_per_epoch):
    assert (loop.val_interval(val_freq, steps_per_epoch)
            == jax_loop.val_interval(val_freq, steps_per_epoch))


def test_guards(workspace, tmp_path):
    """TPU.DEVICE_POOL true builds the device pool (here on the CPU) and
    trains through it; the multi-card flags raise, naming the ROADMAP item
    that carries them."""
    from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool
    from neuralrecon_w_tpu_torch.tools.train_cli import main

    cfg_path, base = workspace
    cfg = port_cfg(cfg_path)
    cfg.TPU.DEVICE_POOL = True
    tr = loop.Trainer(cfg, tcfg(loop, str(tmp_path), "guard"), device="cpu")
    assert tr.use_device_pool and tr.device_pool is None
    tr.fit(max_steps=1)
    assert isinstance(tr.device_pool, DeviceRayPool) and tr.state.step == 1
    assert tr.device_pool.data["rays"].device.type == "cpu"
    for flags in (["--n_devices", "2"], ["--multihost"], ["--coordinator", "localhost:1"]):
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            main(["--cfg_path", cfg_path, "--device", "cpu"] + flags)


# the device-pool run: windows of SCAN_INNER steps, a refresh and a
# validation at POOL_EVERY, a save at POOL_SAVE, POOL_STEPS in all
SCAN_INNER, POOL_EVERY, POOL_SAVE, POOL_STEPS = 3, 6, 9, 10


@pytest.fixture(scope="module")
def pool_runs(workspace, tmp_path_factory):
    """The JAX and the port's Trainer with TPU.DEVICE_POOL true and
    SCAN_INNER 3 from one initialisation (the JAX one carried across), for
    POOL_STEPS steps; then the port resumed for 2 steps from its last
    checkpoint."""
    cfg_path, _ = workspace
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    raw["NEUCONW"]["UPDATE_FREQ"] = POOL_EVERY
    raw["TRAINER"].update(VAL_FREQ=float(POOL_EVERY), SAVE_FREQ=POOL_SAVE)
    raw["TPU"] = {"DEVICE_POOL": True, "SCAN_INNER": SCAN_INNER}
    base = tmp_path_factory.mktemp("pool")
    path = str(base / "pool.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    jtr = jax_loop.Trainer(jax_cfg(path), tcfg(jax_loop, str(base), "jax"), make_mesh(1))
    init = jax.device_get(jtr.state)
    jtr.fit(max_steps=POOL_STEPS)

    tr = loop.Trainer(port_cfg(path), tcfg(loop, str(base), "port", log_every=SCAN_INNER),
                      device="cpu")
    tr.state, _ = state_from_jax(init, tr.fc, tr.opt_spec, device="cpu")
    calls = []
    real = loop.make_scan_train_fn

    def spy(*args, **kw):
        run = real(*args, **kw)

        def counted(state, *a, **k):
            calls.append(int(state.step))
            return run(state, *a, **k)

        counted.release = run.release
        return counted

    loop.make_scan_train_fn = spy
    try:
        tr.fit(max_steps=POOL_STEPS)
    finally:
        loop.make_scan_train_fn = real
    back = loop.Trainer(port_cfg(path), tcfg(loop, str(base), "back", log_every=1,
                                             ckpt_path=latest_checkpoint(tr.ckpt_dir)),
                        device="cpu")
    back.fit(max_steps=2)
    return {"jax": jtr, "port": tr, "back": back, "calls": calls, "base": str(base)}


def test_trainer_device_pool_matches_jax_dispatch(pool_runs):
    """Steps advance by windows where no boundary falls inside one
    (loop.py:293-333): windows at steps 0, 3 and 6, one step at 9; the
    refresh and the validation at step 6 and the saves at 9 and 10, the
    JAX Trainer's steps; the logged losses finite (the two pools draw
    their epochs from different generators, so the batches differ)."""
    jtr, tr = pool_runs["jax"], pool_runs["port"]
    assert tr.state.step == int(jtr.state.step) == POOL_STEPS
    assert pool_runs["calls"] == [0, 3, 6]
    assert [r["step"] for r in tr.refreshes] == [POOL_EVERY]
    assert tr.refreshes[0]["n_kept"] > 0 and tr.fine_grid_host is not None
    jsaves = sorted(int(d.split("_")[1]) for d in os.listdir(jtr.ckpt_dir)
                    if d.startswith("step_"))
    psaves = sorted(int(d[5:-5]) for d in os.listdir(tr.ckpt_dir) if d.endswith(".ckpt"))
    assert psaves == jsaves == [POOL_SAVE, POOL_STEPS]
    jl, pl = logs(pool_runs, "jax"), logs(pool_runs, "port")
    assert [s for s, r in pl.items() if "val/psnr" in r] == [POOL_EVERY]
    assert [s for s, r in jl.items() if "val/psnr" in r] == [POOL_EVERY]
    assert sorted(s for s, r in pl.items() if "loss" in r) == [3, 6, 9, 10]
    assert all(np.isfinite(r[k]) for r in pl.values() if "loss" in r for k in LOSS_KEYS)
    dp = tr.device_pool
    assert dp.sampling == "epoch" and dp._epoch_i >= 1 and dp._cursor > 0


def test_trainer_device_pool_band_cache(pool_runs):
    """The band cache is attached after the refresh (and nowhere before)
    and again when a run resumes with a fine grid; each time every pool
    row equals grid_near_far(first_only=True) of the grid."""
    from neuralrecon_w_tpu_torch.ops.ray_voxel import grid_near_far

    for name, n_attach in (("port", 1), ("back", 1)):
        tr = pool_runs[name]
        assert len(tr.attach_seconds) == n_attach, name
        data = tr.device_pool.data
        surf, _, hit = grid_near_far(tr.fine_dgrid, tr.train_level, data["rays"][:, 0:3],
                                     data["rays"][:, 3:6], first_only=True)
        assert torch.equal(data["surf_t"], surf) and torch.equal(data["surf_hit"], hit), name
        assert bool(hit.any()), name
    back = pool_runs["back"]
    assert back.state.step == POOL_STEPS + 2 and not back.refreshes


def test_profile_window_and_tensorboard_mirror(workspace, tmp_path):
    """TrainerConfig.profile_start / profile_steps open a torch.profiler
    window over those steps and write its Chrome trace under
    <exp_dir>/profile (JAX: a jax.profiler trace, loop.py:292-297); the
    logged scalars are mirrored to a TensorBoard event file beside
    metrics.jsonl (loop.py:50-68)."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    cfg_path, _ = workspace
    tr = loop.Trainer(port_cfg(cfg_path), tcfg(loop, str(tmp_path), "prof", log_every=1,
                                               profile_start=1, profile_steps=2), device="cpu")
    tr.fit(max_steps=3)
    tr.logger.close()
    want = os.path.join(str(tmp_path), "prof", "profile", "trace_step1.json")
    assert tr.profile_traces == [want]
    with open(want) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "train.render_loss" in names and "train.optimizer" in names
    logged = read_log(tr.logger.path)
    events = EventAccumulator(os.path.dirname(tr.logger.path))
    events.Reload()
    got = {e.step: e.value for e in events.Scalars("loss")}
    assert sorted(got) == [1, 2, 3]
    for step, v in got.items():
        assert v == pytest.approx(logged[step]["loss"], rel=1e-6)
