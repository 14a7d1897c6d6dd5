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
    from neuralrecon_w_tpu_torch.tools.convert import init_field

    torch.set_num_threads(1)
    cfg = load_cfg(os.path.join(ROOT, "config", "train_brandenburg_gate_tpu.yaml"))
    n = cfg.NEUCONW
    n.SDF_CONFIG.d_hidden, n.SDF_CONFIG.d_out, n.SDF_CONFIG.n_layers = 64, 65, 4
    n.SDF_CONFIG.skip_in = (2,)
    n.COLOR_CONFIG.d_feature, n.N_VOCAB = 64, 4
    fc = field_config_from_cfg(cfg)
    net = init_field(fc, torch.Generator().manual_seed(0)).neuconw.sdf_net.requires_grad_(False)
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
from neuralrecon_w_tpu_torch.tools.convert import init_field
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
model = init_field(fc, torch.Generator().manual_seed(0)).requires_grad_(False)
sfm, fine = device_grid_from_host(sfm_host), device_grid_from_host(fine_host)
rc = render_config_from_cfg(cfg, sfm_level=sfm_host.level, fine_level=fine_host.level,
                            nerf_far_override=True)
outs = [render_image(make_render_fn(fc, rc), model, scene, frames[0], np.zeros(48, np.int64),
                     np.zeros(48, np.int64), wh, 32, fine, sfm)]
assert cs.check_frames(outs, frames[:1], "steady", wh) == []
assert cs.path_check(model, fc, rc, scene, frames[1], fine, sfm, "steady") == []
assert "jax" not in sys.modules and "neuralrecon_w_tpu" not in sys.modules
print("ok")
"""
    proc = run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
