"""PyTorch port, configuration: the port's cfg tree (its NEUCONW, DATASET,
TPU and TRAINER sections) against the JAX package's, on the defaults and on
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
SECTIONS = ("NEUCONW", "DATASET", "TPU", "TRAINER")
YAMLS = sorted(glob.glob(os.path.join(ROOT, "config", "*.yaml")))


def plain(node):
    if isinstance(node, dict):
        return {k: plain(v) for k, v in node.items()}
    return node


def sections(cfg):
    return {s: plain(cfg[s]) for s in SECTIONS}


def test_defaults_match_jax():
    """Every section of the JAX tree, DATASET included (the extraction CLI
    reads DATASET.ROOT_DIR)."""
    want = jax_cfg_defaults()
    assert set(plain(want)) == set(SECTIONS)
    assert sections(config.get_cfg_defaults()) == sections(want)


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_yaml_merge_matches_jax(path):
    """Same values, same types (tuples, floats, bools) after the merge, and
    so the same FieldConfig and RenderConfig."""
    want = jax_cfg_defaults()
    want.merge_from_file(path)
    got = config.load_cfg(path)
    assert sections(got) == sections(want)
    for s in SECTIONS:
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


@pytest.mark.parametrize("fused_bg", [True, False, "auto"])
def test_fused_field_and_background_config_matches_jax(fused_bg):
    """SDF_GRAD_MODE 'pallas_field' with FUSED_BG on, off and 'auto': the
    same FieldConfig as the JAX package's on the CPU ('auto' is off there in
    the JAX package; in the port it is off on a card too, the faster
    background there)."""
    from neuralrecon_w_tpu.models import field_config_from_cfg as jax_field_config

    path = os.path.join(ROOT, "config", "train_brandenburg_gate_tpu.yaml")
    want_cfg = jax_cfg_defaults()
    want_cfg.merge_from_file(path)
    got_cfg = config.load_cfg(path)
    for cfg in (want_cfg, got_cfg):
        cfg.TPU.SDF_GRAD_MODE, cfg.TPU.FUSED_BG = "pallas_field", fused_bg
    got, want = config.field_config_from_cfg(got_cfg), jax_field_config(want_cfg)
    assert tuple(got) == tuple(want) and got._fields == want._fields
    assert got.grad_mode == "pallas_field"
    assert got.bg_mode == ("pallas" if fused_bg is True else "xla")


@pytest.mark.parametrize("fused_bg, bg_mode", [("auto", "xla"), (True, "pallas")])
def test_fused_bg_on_a_card(monkeypatch, fused_bg, bg_mode):
    """With a CUDA device present, FUSED_BG 'auto' still runs the 'xla'
    background (K8 / K9 lose to it on the H100, PERF.md) and True the fused
    kernels."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = config.load_cfg(os.path.join(ROOT, "config", "train_brandenburg_gate_tpu.yaml"))
    cfg.TPU.SDF_GRAD_MODE, cfg.TPU.FUSED_BG = "pallas_field", fused_bg
    assert config.field_config_from_cfg(cfg).bg_mode == bg_mode


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
