"""The benchmark's work counts and peaks."""

import pytest

from benchmark import harness
from benchmark.counts import field, peaks, sampler


def test_sdf_net_count_at_the_published_widths():
    sdf = harness.config("bg_op")["NEUCONW"]["SDF_CONFIG"]
    prods = field.sdf_products(sdf)
    assert prods == [(39, 512), (512, 512), (512, 512), (512, 473), (512, 512), (512, 512),
                     (512, 512), (512, 512), (512, 513)]
    assert field.macs(prods) == 2_097_664
    assert field.macs(field.sdf_head_products(sdf)) == 2_097_664 - 512 * 512


@pytest.mark.parametrize("name, fg, bg", [("bg_op", 30, 11), ("bg_ref", 34, 38)])
def test_samples_per_ray(name, fg, bg):
    s = field.samples_per_ray(harness.config(name))
    assert (s["fg"], s["bg"], s["sampler"]) == (fg, bg, 16)


def test_step_operations():
    """bg_op: 30 foreground samples at 3 x (SDF, its input gradient, the
    colour head), 11 background points, 16 sampler evaluations a ray."""
    cfg = harness.config("bg_op")
    n = cfg["NEUCONW"]
    sdf = field.macs(field.sdf_products(n["SDF_CONFIG"]))
    grad = field.macs(field.sdf_head_products(n["SDF_CONFIG"]))
    cs, cr = (field.macs(p) for p in field.color_products(n["COLOR_CONFIG"], 48, True))
    bp, br = (field.macs(p) for p in field.nerf_products(48, True))
    assert (cs, cr, bp, br) == (575_744, 9_600, 649_856, 9_600)
    want = 2 * (3 * (30 * (sdf + grad + cs) + cr + 11 * bp + br) + 16 * grad)
    assert field.ray_flops(cfg, train=True) == want
    assert 7.4e12 < want * 8192 < 7.6e12
    serve = 2 * (30 * (sdf + grad + cs) + cr + 11 * bp + br + 16 * grad)
    assert field.ray_flops(cfg, train=False) == serve


def test_sampler_launches_and_bound():
    cfg = harness.config("bg_op")
    launches = sampler.launches(cfg, 1000)
    assert [k for k, _, _ in launches] == ["K1", "K2", "K1", "K2"]
    head = field.macs(field.sdf_head_products(cfg["NEUCONW"]["SDF_CONFIG"]))
    assert launches[0][1] == 2.0 * 8000 * head and launches[2][1] == 2.0 * 8000 * head
    # round 0 reads 6 + 16 floats a ray, writes 8 + 8 + 8; the last reads 6 + 32, writes 24
    assert launches[1][2] == 4.0 * 1000 * (22 + 24)
    assert launches[3][2] == 4.0 * 1000 * (38 + 24)
    t = sampler.least_ms(cfg, 1000)
    assert t == pytest.approx(1e3 * sum(peaks.least_seconds(f, b, "bfloat16")
                                        for _, f, b in launches))


def test_peaks_are_the_card_published_ones():
    assert peaks.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 495e12}
    assert peaks.PEAK_BYTES == 3.35e12
    assert peaks.least_seconds(989e12, 0.0, "bfloat16") == 1.0
    assert peaks.least_seconds(0.0, 3.35e12, "float32") == 1.0
