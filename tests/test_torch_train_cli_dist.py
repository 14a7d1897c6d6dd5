"""PyTorch port, ``tools/train_cli`` over several ranks on the CPU (gloo),
on the port's synthetic workspace: two spawned ranks through a refresh,
saves, a validation and a resume, with the ranks' parameters and fine
grids bit for bit equal and rank 0 alone writing; ``--n_devices 2``; and
``--multihost`` as two processes that each read their own share of the
cache splits (tests/test_multihost.py's run, for the port)."""

import json
import os
import subprocess
import sys

import pytest
import yaml

torch = pytest.importorskip("torch")

from neuralrecon_w_tpu_torch.datasets.cache import read_ray_cache  # noqa: E402
from neuralrecon_w_tpu_torch.parallel import mesh  # noqa: E402
from neuralrecon_w_tpu_torch.testing import make_synthetic_scene, ranks  # noqa: E402
from neuralrecon_w_tpu_torch.tools.prepare_data.prepare_data_cache import (  # noqa: E402
    main as cache_main,
)
from neuralrecon_w_tpu_torch.tools.train_cli import main as train_main  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 64  # per process: 32 a rank
STEPS, UPDATE, RESUME = 6, 3, 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two threads a rank: the spawned ranks read it at start-up."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        yield


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The synthetic sphere scene, its cache in 8 splits, and a cfg that
    refreshes every UPDATE steps, saves every UPDATE and validates at
    STEPS (its gt.ply adds the inline mesh F-score)."""
    base = tmp_path_factory.mktemp("dist")
    root = str(base / "sphere_scene")
    os.makedirs(root)
    make_synthetic_scene(root, n_images=6, n_test=1, img_wh=(40, 30))
    cache_main(["--root_dir", root, "--split_to_chunks", "8", "--device", "cpu"])
    cfg = {
        "NEUCONW": {
            "N_SAMPLES": 8, "N_IMPORTANCE": 8, "UP_SAMPLE_STEP": 2, "N_OUTSIDE": 2,
            "BOUNDARY_SAMPLES": 2, "S_VAL_BASE": 1, "SAMPLE_RANGE": 4, "N_VOCAB": 16,
            "ANNEAL_END": 100, "UPDATE_FREQ": UPDATE, "TRAIN_VOXEL_SIZE": 0.12,
            "SDF_CONFIG": {"d_hidden": 64, "d_out": 65, "n_layers": 2, "skip_in": [1]},
            "COLOR_CONFIG": {"d_feature": 64, "d_hidden": 32, "n_layers": 2,
                             "head_channels": 16},
            "MESH_MASK_LIST": ["sky"], "DEPTH_LOSS": True,
        },
        "DATASET": {"ROOT_DIR": root, "DATASET_NAME": "phototourism",
                    "PHOTOTOURISM": {"IMG_DOWNSCALE": 1}},
        "TRAINER": {"SAVE_FREQ": UPDATE, "VAL_FREQ": float(STEPS), "CANONICAL_LR": 1e-3,
                    "CANONICAL_BS": 512},
    }
    paths = {}
    for name, pool in (("host", False), ("device", True)):
        cfg["TPU"] = {"DEVICE_POOL": pool}
        paths[name] = str(base / f"train_{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    return paths, root, str(base)


def argv(cfg_path, save_dir, name, steps, *extra):
    return ["--cfg_path", cfg_path, "--batch_size", str(BATCH), "--test_batch_size", "128",
            "--num_epochs", "100", "--max_steps", str(steps), "--exp_name", name,
            "--save_dir", save_dir, "--device", "cpu", "--log_every", "1", *extra]


def read_json(path):
    with open(path) as f:
        return json.load(f)


def logged_steps(exp_dir):
    with open(os.path.join(exp_dir, "logs", "metrics.jsonl")) as f:
        return [json.loads(line)["step"] for line in f]


def assert_lockstep(a, b):
    assert a["step"] == b["step"]
    assert a["params"] == b["params"]
    assert a["fine_grid"] == b["fine_grid"]
    assert [r["n_kept"] for r in a["refreshes"]] == [r["n_kept"] for r in b["refreshes"]]


def test_two_ranks_train_in_lockstep(workspace, tmp_path):
    """train_cli as two spawned gloo ranks on the sharded device pool:
    refreshes at 3 and (resumed) 6, saves at 3 and 6, a split validation
    at 6, a 2-step resume from the step-6 checkpoint. Both ranks end each
    run with the same parameters and fine grid; rank 0 alone logs and
    writes; no rank loads JAX."""
    paths, _, _ = workspace
    save = str(tmp_path)
    out = str(tmp_path / "rank{rank}.json")
    run = argv(paths["device"], save, "dp", STEPS)
    resume = argv(paths["device"], save, "dp_resume", RESUME, "--ckpt_path",
                  os.path.join(save, "dp", "checkpoints", f"step_{STEPS}.ckpt"))
    mesh.spawn(ranks.cli_rank, 2, (run, resume, 2, mesh.free_coordinator(), out))
    rec = [read_json(out.format(rank=r)) for r in (0, 1)]
    for r in rec:
        assert r["world_size"] == 2 and r["backend"] == "gloo" and r["foreign_modules"] == []
    a, b = rec[0]["run"], rec[1]["run"]
    assert a["step"] == STEPS and [x["step"] for x in a["refreshes"]] == [UPDATE]
    assert a["fine_grid"] is not None and a["fine_grid"]["n_cells"] > 0
    assert_lockstep(a, b)
    ra, rb = rec[0]["resume"], rec[1]["resume"]
    assert ra["step"] == STEPS + RESUME and [x["step"] for x in ra["refreshes"]] == [STEPS]
    assert_lockstep(ra, rb)
    assert ra["params"] != a["params"]
    assert a["is_main"] and not b["is_main"] and b["logger_path"] is None
    exp = os.path.join(save, "dp")
    assert logged_steps(exp) == list(range(1, STEPS + 1)) + [STEPS]  # + the validation
    assert sorted(os.listdir(os.path.join(exp, "val"))) == [f"val_{STEPS}.png"]
    assert {f for f in os.listdir(os.path.join(exp, "checkpoints")) if f.endswith(".ckpt")} == {
        f"step_{UPDATE}.ckpt", f"step_{STEPS}.ckpt"}
    assert logged_steps(os.path.join(save, "dp_resume")) == [STEPS + 1, STEPS + 2]


def test_n_devices_spawns_ranks(workspace, tmp_path):
    """--n_devices 2 --device cpu: main spawns the two ranks itself (the
    host pool, split by shard_rays) and returns None; the saves' replica
    check passed on both, rank 0 wrote once."""
    paths, _, _ = workspace
    assert train_main(argv(paths["host"], str(tmp_path), "nd", UPDATE + 1,
                           "--n_devices", "2")) is None
    exp = os.path.join(str(tmp_path), "nd")
    assert logged_steps(exp) == list(range(1, UPDATE + 2))
    assert {f for f in os.listdir(os.path.join(exp, "checkpoints"))
            if f.endswith(".ckpt")} == {f"step_{UPDATE}.ckpt", f"step_{UPDATE + 1}.ckpt"}


def test_multihost_processes_read_their_own_splits(workspace, tmp_path):
    """--multihost with --coordinator / --num_processes 2 / --process_id k
    as two processes: each reads its own share of the 8 cache splits (the
    shares add up to the cache), both end with the same parameters and fine
    grid, process 0 alone logs, and neither loads JAX."""
    paths, root, _ = workspace
    coordinator = mesh.free_coordinator()
    outs = [str(tmp_path / f"proc{k}.json") for k in (0, 1)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "neuralrecon_w_tpu_torch.testing.ranks", outs[k], "--",
         *argv(paths["host"], str(tmp_path), "mh", UPDATE + 1, "--multihost", "--coordinator",
               coordinator, "--num_processes", "2", "--process_id", str(k))],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in (0, 1)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for k, p in enumerate(procs):
        assert p.returncode == 0, logs[k][-3000:]
    a, b = (read_json(o) for o in outs)
    assert a["foreign_modules"] == b["foreign_modules"] == []
    assert a["step"] == UPDATE + 1 and a["fine_grid"] is not None
    assert_lockstep(a, b)
    total = len(read_ray_cache(os.path.join(root, "cache_sgs", "splits"))[0])
    assert 0 < a["n_rays"] < total and a["n_rays"] + b["n_rays"] == total
    assert a["is_main"] and not b["is_main"] and b["logger_path"] is None
    assert logged_steps(os.path.join(str(tmp_path), "mh")) == list(range(1, UPDATE + 2))


def test_extract_and_render_clis_split_over_ranks(workspace, tmp_path):
    """extract_mesh_cli and render_cli as two gloo ranks (what they spawn on
    a host with several cards): the mesh and the images bit for bit those
    of one rank, written by rank 0 alone."""
    import numpy as np
    from PIL import Image

    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg
    from neuralrecon_w_tpu_torch.tools import extract_mesh_cli, render_cli
    from neuralrecon_w_tpu_torch.models.neuconw import init_field
    from neuralrecon_w_tpu_torch.training.checkpoint import save_checkpoint
    from neuralrecon_w_tpu_torch.utils.ply import read_ply

    paths, _, _ = workspace
    fc = field_config_from_cfg(load_cfg(paths["host"]))
    ck = save_checkpoint(str(tmp_path / "init.ckpt"),
                         init_field(fc, torch.Generator().manual_seed(0), "cpu"), 0)
    common = ["--cfg_path", paths["host"], "--ckpt_path", ck, "--device", "cpu"]
    ext = common + ["--mesh_size", "40", "--chunk", "4096", "--vertex_color"]
    ren = common + ["--chunk", "128", "--dispatch", "chunk", "--img_downscale", "1"]
    one = extract_mesh_cli.main(ext + ["--out", str(tmp_path / "one.ply")])
    render_cli.main(ren + ["--out_dir", str(tmp_path / "one")])
    for fn, argv in ((extract_mesh_cli.extract, ext + ["--out", str(tmp_path / "two.ply")]),
                     (render_cli.render, ren + ["--out_dir", str(tmp_path / "two")])):
        opts = (extract_mesh_cli if fn is extract_mesh_cli.extract else render_cli).get_opts(argv)
        mesh.spawn(mesh.run_rank, 2, (fn, opts, 2, 1, 0, mesh.free_coordinator(), None, "cpu"))
    a, b = read_ply(one.path), read_ply(str(tmp_path / "two.ply"))
    assert len(one.mesh.verts) > 0 and a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    names = sorted(os.listdir(tmp_path / "one"))
    assert names and names == sorted(os.listdir(tmp_path / "two"))
    for n in names:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "one" / n)),
                                      np.asarray(Image.open(tmp_path / "two" / n)), err_msg=n)
