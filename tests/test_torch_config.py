"""PyTorch port, configuration: the port's cfg tree (the NEUCONW and TPU
sections it reads) against the JAX package's, on the defaults and on
every per-scene YAML, and the label names it maps."""

import glob
import os

import pytest

torch = pytest.importorskip("torch")

from neuralrecon_w_tpu.config import get_cfg_defaults as jax_cfg_defaults  # noqa: E402
from neuralrecon_w_tpu.datasets.mask_utils import get_label_id_mapping as jax_labels  # noqa: E402
from neuralrecon_w_tpu_torch import config  # noqa: E402
from neuralrecon_w_tpu_torch.datasets.mask_utils import get_label_id_mapping  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "config", "*.yaml")))


def plain(node):
    if isinstance(node, dict):
        return {k: plain(v) for k, v in node.items()}
    return node


def sections(cfg):
    return {s: plain(cfg[s]) for s in ("NEUCONW", "TPU")}


def test_defaults_match_jax():
    assert sections(config.get_cfg_defaults()) == sections(jax_cfg_defaults())


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_yaml_merge_matches_jax(path):
    """Same values, same types (tuples, floats, bools) after the merge, and
    so the same FieldConfig and RenderConfig."""
    want = jax_cfg_defaults()
    want.merge_from_file(path)
    got = config.load_cfg(path)
    assert sections(got) == sections(want)
    for s in ("NEUCONW", "TPU"):
        for k, v in plain(want[s]).items():
            assert type(plain(got[s])[k]) is type(v), f"{s}.{k}"
    assert config.field_config_from_cfg(got) == config.field_config_from_cfg(want)
    assert (config.render_config_from_cfg(got, sfm_level=8, fine_level=10)
            == config.render_config_from_cfg(want, sfm_level=8, fine_level=10))


def test_operating_point():
    cfg = config.load_cfg(os.path.join(ROOT, "config", "train_brandenburg_gate_tpu.yaml"))
    fc = config.field_config_from_cfg(cfg)
    rc = config.render_config_from_cfg(cfg)
    assert fc.act_dtype == "bfloat16" and fc.grad_mode == "vjp" and fc.bg_mode == "xla"
    assert dict(fc.sdf)["skip_in"] == (4,) and (fc.n_vocab, fc.n_a) == (5000, 48)
    assert (rc.n_samples, rc.n_importance, rc.up_sample_steps, rc.s_val_base) == (8, 16, 2, 3)
    assert (rc.boundary_samples, rc.n_outside, rc.bg_samples) == (6, 4, 8)
    assert rc.nerf_far_override and rc.fused_sampler_sdf
    assert rc.mesh_mask_ids == (2,) and rc.floor_label_ids == (6,)


def test_merge_refuses_unknown_keys_and_cycles(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("NEUCONW:\n  N_SAMPLEZ: 8\n")
    with pytest.raises(KeyError):
        config.load_cfg(str(bad))
    loop = tmp_path / "loop.yaml"
    loop.write_text("_BASE_: loop.yaml\n")
    with pytest.raises(ValueError):
        config.load_cfg(str(loop))


def test_label_ids_match_jax():
    assert get_label_id_mapping() == jax_labels()
