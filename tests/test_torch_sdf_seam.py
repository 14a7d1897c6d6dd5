"""PyTorch port, the SDF net's seam on the CPU at tiny widths: both nets
(the MLP of ``config/train_brandenburg_gate_tpu.yaml`` and Neuralangelo's
hash grid, sized as ``test_torch_neuralangelo.py`` sizes it) answer the
calls the field, the sampler, the sweeps and the trainer make, and each
call gives bit for bit what the path it stands for gives."""

import os

import pytest

torch = pytest.importorskip("torch")

from neuralrecon_w_tpu_torch.config import (field_config_from_cfg, load_cfg,  # noqa: E402
                                            render_config_from_cfg)
from neuralrecon_w_tpu_torch.models.neuconw import field_sdf, init_field  # noqa: E402
from neuralrecon_w_tpu_torch.ops.importance_sampler import (  # noqa: E402
    fused_importance_sampler, importance_plain, importance_rounds, importance_sampler_plain)
from neuralrecon_w_tpu_torch.ops.sdf_mlp import (fused_field_sdf, fused_sdf_head,  # noqa: E402
                                                 pack_sdf_weights, sdf_mlp_plain)
from neuralrecon_w_tpu_torch.rendering.renderer import importance_stage  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def tiny_cfg(kind):
    if kind == "mlp":
        cfg = load_cfg(os.path.join(ROOT, "config", "train_brandenburg_gate_tpu.yaml"))
        sdf = {"d_hidden": 64, "d_out": 65, "n_layers": 4, "skip_in": (2,)}
        color = (64, 32, 2)
    else:
        cfg = load_cfg(os.path.join(ROOT, "neuralrecon_w_tpu_torch", "configs",
                                    "train_neuralangelo_op.yaml"))
        sdf = {"levels": 6, "log2_table": 12, "min_res": 4, "max_res": 64, "d_hidden": 32,
               "d_out": 33}
        color = (32, 32, 2)
    n = cfg.NEUCONW
    for k, v in sdf.items():
        n.SDF_CONFIG[k] = v
    n.COLOR_CONFIG.d_feature, n.COLOR_CONFIG.d_hidden, n.COLOR_CONFIG.n_layers = color
    n.N_VOCAB = 16
    return cfg


@pytest.mark.parametrize("kind", ["mlp", "hashgrid"])
def test_both_sdf_nets_answer_the_field_seam(kind):
    cfg = tiny_cfg(kind)
    fc = field_config_from_cfg(cfg)
    # the field's init: one seed, one field, drawn in one order
    first, second = (init_field(fc, torch.Generator().manual_seed(5), "cpu").state_dict()
                     for _ in range(2))
    assert first.keys() == second.keys()
    assert all(torch.equal(first[k], second[k]) for k in first)

    model = init_field(fc, torch.Generator().manual_seed(5), "cpu").requires_grad_(False)
    net = model.neuconw.sdf_net
    # the step and the curvature weight's decay
    if kind == "mlp":
        before = {k: v.clone() for k, v in net.state_dict().items()}
        assert model.set_step(4000) is None and model.set_step(torch.tensor(9.0)) is None
        assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
        assert model.curvature_decay() is None
    else:
        model.set_step(0)
        assert int(net.active) == net.init_active
        start = model.curvature_decay()
        model.set_step(torch.tensor(6000.0, dtype=torch.float64))
        assert int(net.active) == net.levels_at(6000) > net.init_active
        assert model.curvature_decay().dim() == 0 and float(model.curvature_decay()) < float(start)

    # the sampler's and the sweeps' SDF
    g = torch.Generator().manual_seed(1)
    pts = (torch.rand(777, 3, generator=g) * 2 - 1) * 0.9
    if kind == "mlp":
        assert torch.equal(net.sdf_fn("float32")(pts), fused_field_sdf(model, fc, pts))
        packed = pack_sdf_weights(net, fc.sdf, fc.act_dtype)
        assert torch.equal(net.sdf_fn(fc.act_dtype)(pts), fused_sdf_head(packed, pts))
        assert torch.equal(net.sdf_fn(fc.act_dtype, plain=True)(pts), sdf_mlp_plain(packed, pts))
    else:
        for plain in (False, True):
            assert torch.equal(net.sdf_fn(fc.act_dtype, plain)(pts), field_sdf(model, fc, pts))

    # the importance stage over it, the kernels' path and the plain one
    rc = render_config_from_cfg(cfg)
    o = torch.tensor([[0.0, 0.0, -1.5]]) + (torch.rand(24, 3, generator=g) - 0.5) * 0.1
    d = torch.nn.functional.normalize(-o + (torch.rand(24, 3, generator=g) - 0.5) * 0.3, dim=-1)
    z = torch.linspace(0.3, 2.7, rc.n_samples)[None].expand(24, -1).contiguous()
    args = (rc.n_importance, rc.up_sample_steps, rc.s_val_base)
    for fused in (True, False):
        got = importance_stage(model, fc, rc._replace(fused_sampler_sdf=fused), o, d, z)
        if kind == "mlp":
            sampler = fused_importance_sampler if fused else importance_sampler_plain
            want = sampler(net, fc.sdf, o, d, z, *args, act_dtype=fc.act_dtype)
        else:
            rounds = importance_rounds if fused else importance_plain
            want = rounds(lambda p: field_sdf(model, fc, p), o, d, z, *args)
        assert got.shape == (24, rc.n_samples + rc.n_importance)
        assert torch.equal(got, want), fused
