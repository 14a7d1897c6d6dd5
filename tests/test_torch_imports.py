"""The port's standing rules, checked on the CPU: it imports nothing of
JAX or of the JAX package (every module parsed, not imported); its layers
below the entry points import nothing of ``tools/``; only ``models/``
knows the SDF net's kind; and its entry points build on the card unless
the caller names a device."""

import ast
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(ROOT, "neuralrecon_w_tpu_torch", "**", "*.py"),
                         recursive=True)) + [os.path.join(ROOT, "chip_smoke.py"),
                                             os.path.join(ROOT, "chip_smoke_neuralangelo.py"),
                                             os.path.join(ROOT, "scripts", "torch_k2_turns.py"),
                                             os.path.join(ROOT, "scripts",
                                                          "torch_trainer_refresh.py")]
FORBIDDEN = ("jax", "neuralrecon_w_tpu")  # exact top-level names


def forbidden_imports(path: str) -> list:
    """Every ``import`` / ``from`` of a forbidden top-level package in the
    file, wherever it stands (a function body included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return bad


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_nothing_of_jax(path):
    assert forbidden_imports(path) == []


def test_guard_sees_imports_inside_functions(tmp_path):
    """What the port's converter once did, an import of the JAX package's
    exporter inside a function, is caught; the port's own package and
    relative imports are not."""
    p = tmp_path / "m.py"
    p.write_text("from . import build\nimport neuralrecon_w_tpu_torch.ops\n\n"
                 "def f():\n"
                 "    from neuralrecon_w_tpu.tools.convert_torch_ckpt import export_state_dict\n"
                 "    import jax.numpy as jnp\n")
    assert forbidden_imports(str(p)) == ["neuralrecon_w_tpu.tools.convert_torch_ckpt",
                                         "jax.numpy"]


# ----------------------------- the layers -----------------------------

PORT = os.path.join(ROOT, "neuralrecon_w_tpu_torch")
# the layers below the entry points (tools/); testing/ranks.py, the rank
# harness that drives train_cli, is not one of them
BELOW_TOOLS = ("training", "rendering", "parallel", "models", "ops", "datasets", "evaluation",
               "extraction", "utils")


def port_file(path: str) -> str:
    return os.path.relpath(path, PORT).replace(os.sep, "/")


def imported_modules(path: str) -> list:
    """(line, absolute module name) of every import in a port module, a
    relative one resolved against the module's package; ``from a import b``
    gives both a and a.b."""
    parts = ["neuralrecon_w_tpu_torch"] + port_file(path).split("/")[:-1]
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                base = ".".join(parts[:len(parts) - node.level + 1] + ([base] if base else []))
            out += [(node.lineno, base)] + [(node.lineno, f"{base}.{a.name}") for a in node.names]
    return out


def test_layers_below_the_entry_points_import_nothing_of_tools():
    """training/, rendering/, the field, the kernels and the rest take
    nothing from the entry points' package: the field's init lives in
    models/, the checkpoint format's dead entries in training/checkpoint."""
    tools = "neuralrecon_w_tpu_torch.tools"
    below = [p for p in FILES if p.startswith(PORT + os.sep)
             and port_file(p).split("/")[0] in BELOW_TOOLS]
    bad = [f"{port_file(p)}:{line} {name}" for p in below for line, name in imported_modules(p)
           if name == tools or name.startswith(tools + ".")]
    assert bad == []


def net_kind_reads(path: str) -> list:
    """Every place a module decides the SDF net's kind: a read of
    ``hash_sdf``, a comparison with "hashgrid" (SDF_CONFIG.type) or an
    isinstance test against an SDF net class; config.py's merge of
    HASH_SDF_CONFIG into a hashgrid YAML's SDF_CONFIG aside."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    merge = set()
    if port_file(path) == "config.py":
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef) and fn.name == "_merge":
                merge = {id(n) for n in ast.walk(fn)}
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "hash_sdf":
            bad.append((node.lineno, "hash_sdf"))
        elif isinstance(node, ast.Compare) and id(node) not in merge and any(
                isinstance(c, ast.Constant) and c.value == "hashgrid"
                for c in [node.left] + node.comparators):
            bad.append((node.lineno, "== 'hashgrid'"))
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "isinstance" \
                and any("SDFNetwork" in ast.unparse(a) for a in node.args[1:]):
            bad.append((node.lineno, "isinstance SDFNetwork"))
    return bad


def test_only_models_knows_the_sdf_net_kind():
    """A new SDF net kind is a class in models/ and a config in config.py:
    no renderer, sweep, trainer, converter or CLI branches on the kind."""
    bad = [f"{port_file(p)}:{line} {what}"
           for p in FILES if p.startswith(PORT + os.sep) and not port_file(p).startswith("models/")
           for line, what in net_kind_reads(p)]
    assert bad == []


# ------------------------- the default device -------------------------


def small_fc():
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, get_cfg_defaults

    cfg = get_cfg_defaults()
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out = 64, 65
    n.SDF_CONFIG.n_layers, n.SDF_CONFIG.skip_in = 4, (2,)
    n.COLOR_CONFIG.d_feature, n.COLOR_CONFIG.d_hidden, n.COLOR_CONFIG.n_layers = 64, 32, 2
    n.N_VOCAB = 4
    return cfg, field_config_from_cfg(cfg)


def entry_points(tmp_path):
    """(name, call(device)) for each entry point that takes a device."""
    from neuralrecon_w_tpu_torch.extraction import dense_eval_grid, extract_mesh
    from neuralrecon_w_tpu_torch.models.neuconw import NeuconWField, init_field
    from neuralrecon_w_tpu_torch.ops.ray_voxel import device_grid_from_host
    from neuralrecon_w_tpu_torch.ops.voxel_grid import VoxelGrid
    from neuralrecon_w_tpu_torch.parallel.sweep import sharded_rgb_sweep, sharded_sdf_sweep
    from neuralrecon_w_tpu_torch.training.checkpoint import load_field, save_checkpoint
    from neuralrecon_w_tpu_torch.training.schedule import make_optimizer
    from neuralrecon_w_tpu_torch.training.step import init_state
    from neuralrecon_w_tpu_torch.utils.scene import scene_info

    cfg, fc = small_fc()
    g = torch.Generator().manual_seed(0)
    cpu_model = init_field(fc, g, "cpu").requires_grad_(False)
    ckpt = save_checkpoint(str(tmp_path / "m.ckpt"), cpu_model, 0)
    pts = np.zeros((5, 3), np.float32)
    grid = VoxelGrid(2, np.zeros(3), 1.0, np.zeros((1, 3), np.int32))
    spec, _ = make_optimizer(cfg, 64)
    # the sweeps and extract_mesh take a model; given a CPU model and no
    # device they move the points to the card, where no card means an error
    return [
        ("NeuconWField", lambda d: NeuconWField(fc, d).embedding_a.weight),
        ("init_field", lambda d: init_field(fc, g, d).embedding_a.weight),
        ("init_state", lambda d: init_state(fc, spec, g, d).model.embedding_a.weight),
        ("scene_info", lambda d: scene_info({"origin": [0, 0, 0], "radius": 2.0}, d).origin),
        ("device_grid_from_host", lambda d: device_grid_from_host(grid, d).occ),
        ("load_field", lambda d: load_field(ckpt, fc, d).embedding_a.weight),
    ], [
        ("sharded_sdf_sweep", lambda d: sharded_sdf_sweep(cpu_model, fc, pts, 4, d)),
        ("sharded_rgb_sweep", lambda d: sharded_rgb_sweep(cpu_model, fc, pts, (0, 0, 1), 0, 4, d)),
        ("extract_mesh", lambda d: extract_mesh(cpu_model, fc, dense_eval_grid(
            np.zeros(3), 1.0, 4), np.zeros(3), 1.0, device=d)),
    ]


def test_default_device_is_the_card():
    from neuralrecon_w_tpu_torch.device import default_device

    assert default_device() == torch.device("cuda")
    assert default_device("cpu") == torch.device("cpu")


def test_entry_points_run_on_the_card_unless_asked(tmp_path):
    """With no device, each entry point puts its tensors on the card: here,
    with no card, it raises instead of building on the CPU. Asked for the
    CPU, each runs there."""
    builders, sweeps = entry_points(tmp_path)
    for name, call in builders:
        assert call("cpu").device.type == "cpu", name
        if torch.cuda.is_available():
            assert call(None).device.type == "cuda", name
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call(None)
    for name, call in sweeps:
        call("cpu")
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                call(None)


def test_training_entry_points_run_on_the_card_unless_asked(tmp_path):
    """The scene bundle, the voxel near / far filter, the Trainer and the
    three CLIs that take --device: asked for the CPU they run there; with
    no device they go to the card, which here means an error."""
    import yaml

    from neuralrecon_w_tpu_torch.config import load_cfg
    from neuralrecon_w_tpu_torch.datasets.phototourism import (apply_voxel_near_far,
                                                               build_image_rays, load_scene_meta)
    from neuralrecon_w_tpu_torch.testing import make_synthetic_scene
    from neuralrecon_w_tpu_torch.tools import render_cli, train_cli
    from neuralrecon_w_tpu_torch.tools.prepare_data import prepare_data_cache
    from neuralrecon_w_tpu_torch.training.checkpoint import save_checkpoint
    from neuralrecon_w_tpu_torch.training.loop import Trainer, TrainerConfig
    from neuralrecon_w_tpu_torch.utils.scene import load_scene_bundle

    torch.set_num_threads(1)
    root = str(tmp_path / "scene")
    make_synthetic_scene(root, n_images=6, n_test=1, img_wh=(16, 12), n_points=200)
    cache = ["--root_dir", root, "--split_to_chunks", "2", "--cache_type", "npz"]
    prepare_data_cache.main(cache + ["--device", "cpu"])
    small, _ = small_fc()
    cfg_path = str(tmp_path / "c.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"NEUCONW": {"SDF_CONFIG": dict(small.NEUCONW.SDF_CONFIG, skip_in=[2]),
                                    "COLOR_CONFIG": dict(small.NEUCONW.COLOR_CONFIG),
                                    "N_VOCAB": 8},
                        "DATASET": {"ROOT_DIR": root}}, f)
    cfg = load_cfg(cfg_path)
    meta = load_scene_meta(root)
    rays, rgbs = build_image_rays(meta, meta.img_ids_train[0])
    tcfg = TrainerConfig(save_dir=str(tmp_path / "runs"))
    trainer = Trainer(cfg, tcfg, device="cpu")
    ckpt = save_checkpoint(str(tmp_path / "m.ckpt"), trainer.state.model, 0)
    builders = [
        ("load_scene_bundle", lambda d: load_scene_bundle(cfg, device=d).scene.origin),
        ("Trainer", lambda d: next(Trainer(cfg, tcfg, device=d).state.model.parameters())),
    ]
    for name, call in builders:
        assert call("cpu").device.type == "cpu", name
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                call(None)
    assert len(apply_voxel_near_far(rays, rgbs, meta, device="cpu")[0]) > 0
    clis = [
        ("apply_voxel_near_far", lambda extra: apply_voxel_near_far(rays, rgbs, meta, **(
            {"device": extra[1]} if extra else {}))),
        ("prepare_data_cache", lambda extra: prepare_data_cache.main(cache + extra)),
        ("train_cli", lambda extra: train_cli.main(
            ["--cfg_path", cfg_path, "--max_steps", "0", "--save_dir", str(tmp_path / "cli"),
             "--batch_size", "16"] + extra)),
        ("render_cli", lambda extra: render_cli.main(
            ["--cfg_path", cfg_path, "--ckpt_path", ckpt, "--out_dir", str(tmp_path / "r"),
             "--img_downscale", "2"] + extra)),
    ]
    for name, call in clis:
        call(["--device", "cpu"])
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                call([])
