"""PyTorch port, end to end on the synthetic sphere, on the CPU: the
port's mirror of tests/test_e2e.py:79-191 through its own entry points
(ray cache -> train_cli -> extract_mesh_cli -> eval_mesh -> render_cli ->
resume), with the same gates and bands (docs/e2e_gate_calibration.json).
The split table is the one make_synthetic_scene writes (the last view
held out): the port has no split CLI. Slow (300 training steps); the
card runs the same flow in chip_smoke.py's e2e_gate_phase."""

import os

import numpy as np
import pytest
import yaml

pytest.importorskip("torch")

pytestmark = pytest.mark.slow

DEVICE = ["--device", "cpu"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from neuralrecon_w_tpu_torch.testing import make_synthetic_scene

    root = str(tmp_path_factory.mktemp("scene") / "sphere_scene")
    os.makedirs(root)
    info = make_synthetic_scene(root, n_images=6, n_test=1, img_wh=(40, 30))
    return root, info


@pytest.fixture(scope="module")
def cfg_path(scene, tmp_path_factory):
    root, _ = scene
    cfg = {
        "NEUCONW": {
            "N_SAMPLES": 8, "N_IMPORTANCE": 8, "UP_SAMPLE_STEP": 2,
            "N_OUTSIDE": 2, "BOUNDARY_SAMPLES": 2, "S_VAL_BASE": 1,
            "SAMPLE_RANGE": 4, "N_VOCAB": 16, "ANNEAL_END": 100,
            "UPDATE_FREQ": 100, "TRAIN_VOXEL_SIZE": 0.12,
            "SDF_THRESHOLD": 0.1, "NEAR_FAR_OVERRIDE": True,
            "SDF_CONFIG": {"d_hidden": 64, "d_out": 65, "n_layers": 4, "skip_in": [2]},
            "COLOR_CONFIG": {"d_feature": 64, "d_hidden": 32, "n_layers": 2,
                             "head_channels": 16},
            "MESH_MASK_LIST": ["sky"],
            "DEPTH_LOSS": True,
            "LOSS": {"depth_weight": 1.0},
        },
        "DATASET": {"ROOT_DIR": root, "DATASET_NAME": "phototourism",
                    "PHOTOTOURISM": {"IMG_DOWNSCALE": 1}},
        "TRAINER": {"SAVE_FREQ": 1000, "VAL_FREQ": 100.0, "CANONICAL_LR": 1e-3,
                    "CANONICAL_BS": 512},
    }
    path = str(tmp_path_factory.mktemp("cfg") / "train_sphere.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_01_prepare_cache(scene):
    root, _ = scene
    from neuralrecon_w_tpu_torch.tools.prepare_data.prepare_data_cache import main

    split_root = main(["--root_dir", root, "--split_to_chunks", "8"] + DEVICE)
    assert os.path.exists(os.path.join(split_root, "split_0", "rays1.h5"))
    assert os.path.exists(os.path.join(split_root, "rays1_meta_info.json"))


def test_02_train(scene, cfg_path, tmp_path_factory):
    from neuralrecon_w_tpu_torch.tools.train_cli import main
    from neuralrecon_w_tpu_torch.training.checkpoint import latest_checkpoint

    save_dir = str(tmp_path_factory.mktemp("run"))
    trainer = main(["--cfg_path", cfg_path, "--batch_size", "512", "--test_batch_size", "128",
                    "--num_epochs", "100", "--max_steps", "300", "--exp_name", "sphere",
                    "--save_dir", save_dir] + DEVICE)
    assert trainer.state.step == 300
    # tests/test_e2e.py's band: the refresh fired and left a non-degenerate grid
    assert trainer.fine_grid_host is not None
    n_vox = int(trainer.fine_grid_host.coords.shape[0])
    assert 8000 <= n_vox <= 40000, n_vox
    log = os.path.join(save_dir, "sphere", "logs", "metrics.jsonl")
    assert os.path.getsize(log) > 0
    ck = latest_checkpoint(os.path.join(save_dir, "sphere", "checkpoints"))
    assert ck is not None and ck.endswith("step_300.ckpt")
    test_02_train.ckpt = ck
    test_02_train.save_dir = save_dir
    print(f"fine voxels {n_vox}")


def test_03_extract_and_eval(scene, cfg_path, tmp_path_factory):
    _, info = scene
    from neuralrecon_w_tpu_torch.evaluation import eval_mesh
    from neuralrecon_w_tpu_torch.tools.extract_mesh_cli import main as extract_main
    from neuralrecon_w_tpu_torch.utils.ply import read_ply, write_ply

    out = str(tmp_path_factory.mktemp("mesh") / "mesh.ply")
    res = extract_main(["--cfg_path", cfg_path, "--ckpt_path", test_02_train.ckpt,
                        "--mesh_size", "48", "--chunk", "8192", "--vertex_color",
                        "--a_index", "1", "--out", out] + DEVICE)
    assert res.path == out and os.path.exists(out)
    mesh = read_ply(out)
    assert len(mesh["verts"]) > 50
    assert "colors" in mesh

    rs = np.random.RandomState(0)
    v = rs.randn(4000, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    gt_path = str(tmp_path_factory.mktemp("gt") / "gt.ply")
    write_ply(gt_path, v * info["sphere_radius"])
    res = eval_mesh(out, gt_path, info["scene_config"], is_mesh=True, threshold=[0.5],
                    save_name="e2e", write_visualizations=False)
    print(res)
    # tests/test_e2e.py's gates (mean -/+ 4 sigma of its 5 seeded runs)
    assert res["fscores"][0] > 0.14, res
    assert res["chamfer_pred_to_gt"] < 0.62, res
    assert res["chamfer_gt_to_pred"] < 0.84, res


def test_04_render_cli_from_trained_ckpt(cfg_path, tmp_path_factory):
    from PIL import Image

    from neuralrecon_w_tpu_torch.tools.render_cli import main as render_main
    from neuralrecon_w_tpu_torch.training.checkpoint import restore_checkpoint

    assert "fine_grid" in restore_checkpoint(test_02_train.ckpt)
    out = str(tmp_path_factory.mktemp("render"))
    render_main(["--cfg_path", cfg_path, "--ckpt_path", test_02_train.ckpt, "--out_dir", out,
                 "--img_downscale", "2", "--chunk", "120"] + DEVICE)
    pngs = [p for p in os.listdir(out) if p.startswith("view_")
            and not p.endswith(("_depth.png", "_normal.png"))]
    assert len(pngs) == 1
    img = np.asarray(Image.open(os.path.join(out, pngs[0])), np.float32)
    assert img.shape == (15, 20, 3)
    assert img.std() > 5.0


def test_05_resume(cfg_path):
    from neuralrecon_w_tpu_torch.tools.train_cli import main

    trainer = main(["--cfg_path", cfg_path, "--batch_size", "512", "--test_batch_size", "128",
                    "--num_epochs", "100", "--max_steps", "2", "--exp_name", "sphere_resume",
                    "--save_dir", test_02_train.save_dir, "--ckpt_path", test_02_train.ckpt,
                    "--divide_lr"] + DEVICE)
    assert trainer.state.step == 302
