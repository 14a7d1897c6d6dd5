"""PyTorch port, render_cli: the views, appearance override, appearance
and pose interpolation and the GIF of tests/test_render_cli.py's cases,
from one checkpoint written by each package (the JAX initialisation
carried across, a fine grid in both), PERTURB 0: the port's PNGs equal
the JAX package's within 1 level."""

import os

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neuralrecon_w_tpu.config import get_cfg_defaults  # noqa: E402
from neuralrecon_w_tpu.models.neuconw import field_config_from_cfg as jax_fc  # noqa: E402
from neuralrecon_w_tpu.models.neuconw import init_field as jax_init_field  # noqa: E402
from neuralrecon_w_tpu.ops.voxel_grid import VoxelGrid  # noqa: E402
from neuralrecon_w_tpu.testing import make_synthetic_scene  # noqa: E402
from neuralrecon_w_tpu.tools.render_cli import main as jax_main  # noqa: E402
from neuralrecon_w_tpu.training.checkpoint import save_checkpoint as jax_save  # noqa: E402
from neuralrecon_w_tpu.utils.scene import load_scene_bundle  # noqa: E402
from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg  # noqa: E402
from neuralrecon_w_tpu_torch.ops.voxel_grid import VoxelGrid as PortGrid  # noqa: E402
from neuralrecon_w_tpu_torch.ops.voxel_grid import _sort_coords  # noqa: E402
from neuralrecon_w_tpu_torch.tools.convert import field_from_jax  # noqa: E402
from neuralrecon_w_tpu_torch.tools.render_cli import main  # noqa: E402
from neuralrecon_w_tpu_torch.training.checkpoint import save_checkpoint  # noqa: E402

torch.set_num_threads(2)

PIXEL_LEVELS = 1  # uint8 levels, every channel of every PNG


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """tests/test_render_cli.py's workspace and cfg (PERTURB 0), the JAX
    initialisation with a fine grid (the SFM grid's cells at the training
    level within 0.15 of the sphere), as an orbax checkpoint and as the
    port's .ckpt."""
    base = tmp_path_factory.mktemp("render")
    root = str(base / "sphere_scene")
    os.makedirs(root)
    make_synthetic_scene(root, n_images=6, n_test=1, img_wh=(40, 30))
    cfg_dict = {
        "NEUCONW": {
            "N_SAMPLES": 8, "N_IMPORTANCE": 4, "UP_SAMPLE_STEP": 1, "N_OUTSIDE": 2,
            "BOUNDARY_SAMPLES": 2, "S_VAL_BASE": 1, "SAMPLE_RANGE": 4, "N_VOCAB": 16,
            "NEAR_FAR_OVERRIDE": True, "PERTURB": 0.0,
            "SDF_CONFIG": {"d_hidden": 32, "d_out": 33, "n_layers": 2, "skip_in": []},
            "COLOR_CONFIG": {"d_feature": 32, "d_hidden": 16, "n_layers": 2,
                             "head_channels": 8},
        },
        "DATASET": {"ROOT_DIR": root, "DATASET_NAME": "phototourism",
                    "PHOTOTOURISM": {"IMG_DOWNSCALE": 1}},
    }
    cfg_path = str(base / "train_sphere.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg_dict, f)
    cfg = get_cfg_defaults()
    cfg.merge_from_file(cfg_path)
    params = jax.device_get(jax_init_field(jax.random.PRNGKey(0), jax_fc(cfg)))
    sfm = load_scene_bundle(cfg).sfm_grid
    dense = sfm.upsample(sfm.level + 2)
    keep = np.abs(np.linalg.norm(dense.centers_sfm(), axis=-1) - 1.0) < 0.15
    assert 0 < keep.sum() < len(keep)
    grid = VoxelGrid(dense.level, dense.origin, dense.scale, dense.coords[keep])
    jax_ck = jax_save(str(base / "ck"), 7, params, fine_grid=grid)
    pcfg = load_cfg(cfg_path)
    model = field_from_jax(params, field_config_from_cfg(pcfg), "cpu")
    port_ck = save_checkpoint(str(base / "ck.ckpt"), model, 7, fine_grid=PortGrid(
        grid.level, grid.origin, grid.scale, _sort_coords(grid.coords, grid.level)))
    return cfg_path, jax_ck, port_ck, str(base)


CASES = {
    "views": ["--img_ids", "1,4"],
    "a_index": ["--a_index", "9"],
    "interp": ["--a_interp", "1,3", "--frames", "3", "--pose_interp", "--gif"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_cli_matches_jax(setup, case):
    from PIL import Image

    cfg_path, jax_ck, port_ck, base = setup
    common = ["--cfg_path", cfg_path, "--img_downscale", "2", "--chunk", "128"] + CASES[case]
    jout, pout = os.path.join(base, "jax_" + case), os.path.join(base, "port_" + case)
    jax_main(common + ["--ckpt_path", jax_ck, "--out_dir", jout, "--dispatch", "chunk"])
    main(common + ["--ckpt_path", port_ck, "--out_dir", pout, "--device", "cpu"])
    names = sorted(os.listdir(jout))
    assert sorted(os.listdir(pout)) == names and len(names) >= 3
    for name in names:
        if name.endswith(".gif"):
            gif = Image.open(os.path.join(pout, name))
            assert gif.is_animated and gif.n_frames == 4
            continue
        a = np.asarray(Image.open(os.path.join(pout, name)), np.int32)
        b = np.asarray(Image.open(os.path.join(jout, name)), np.int32)
        assert a.shape == b.shape == (15, 20, 3), name
        assert np.abs(a - b).max() <= PIXEL_LEVELS, name
    frames = [n for n in names if n.endswith(".png") and "_depth" not in n
              and "_normal" not in n]
    img = np.asarray(Image.open(os.path.join(pout, frames[0])), np.float32)
    assert img.std() > 1.0  # a field, not a constant
