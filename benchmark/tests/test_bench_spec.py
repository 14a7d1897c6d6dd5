"""Every cell, configuration, traffic mix and metric of BENCHMARK.json is
found by its name; a new cell, configuration and per-layer metric added as
files alone are picked up."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

from conftest import ROOT, TINY_CFG, TINY_TRAFFIC, tiny_run

SPEC = harness.spec()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_load_by_name(cell):
    wl = harness.workload(SPEC, cell)
    cfg = harness.config(wl["config"])
    tr = harness.traffic(wl["traffic"])
    assert cfg["name"] == wl["config"]
    assert callable(harness.kind(tr["kind"]).run)
    limits = harness.cell_file(cell)["limits"]
    assert limits and all(v >= 0 for v in limits.values())  # 0: an exact number
    e2e = {m["name"] for m in harness.end_to_end_for(SPEC, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.per_layer_for(SPEC, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_readers_load_by_name(metric):
    assert callable(harness.reader(metric).read)


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entries_match_their_files(c):
    f = json.load(open(os.path.join(ROOT, c["file"])))
    assert f["name"] == c["name"] and f["source"] == c["source"] and f["reduced"] == c["reduced"]


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert [m["name"] for m in SPEC["end_to_end"]] == ["train_rays_per_s", "serve_rays_per_s",
                                                        "setup_s"]
    for m in SPEC["per_layer"]:
        e2e = {e["name"]: e for e in SPEC["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(e2e["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_result_line_keys():
    """The contract's keys, ``check`` last, each number beside its limit."""
    r = tiny_run("serve.op")
    assert list(r)[:3] == ["correct", "attempted", "failed"] and list(r)[-1] == "check"
    assert set(r["metrics"]) == {"serve_rays_per_s", "setup_s"}
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in r["check"].values())


def test_new_cell_config_and_metric_are_picked_up(tmp_path):
    """A copy of the benchmark with a cell, a configuration, a traffic mix
    and a per-layer metric added as files and entries, no file edited: the
    new cell runs and reports the new metric."""
    root = tmp_path / "tree"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "neuralrecon_w_tpu_torch"), root / "neuralrecon_w_tpu_torch")
    b = root / "benchmark"
    cfg = json.load(open(b / "configs" / "bg_op.json"))
    cfg = harness.merged(cfg, TINY_CFG)
    cfg["name"] = "tiny"
    json.dump(cfg, open(b / "configs" / "tiny.json", "w"))
    json.dump(dict(TINY_TRAFFIC["serve_frames"], kind="serve_frames", frames=1),
              open(b / "traffic" / "serve_tiny.json", "w"))
    json.dump({"limits": {"color_gap": 1.0, "depth_gap": 1.0}},
              open(b / "workloads" / "serve.tiny.json", "w"))
    (b / "metrics" / "frames_done.serve.py").write_text(
        "def read(rec):\n    return rec['rays'] / (16 * 12)\n")
    spec = dict(SPEC)
    spec["configs"] = SPEC["configs"] + [{"name": "tiny", "source": "a test", "reduced": [],
                                          "file": "benchmark/configs/tiny.json", "why": "test"}]
    spec["workloads"] = SPEC["workloads"] + [{"name": "serve.tiny", "config": "tiny",
                                              "traffic": "serve_tiny", "chips": 1, "why": "t"}]
    spec["end_to_end"] = [dict(m, workloads=m["workloads"] + ["serve.tiny"])
                          if m["name"] == "serve_rays_per_s" else m for m in SPEC["end_to_end"]]
    spec["per_layer"] = [{"name": "frames_done.serve", "unit": "frames", "better": "higher",
                          "source": "program_counter", "layer": "dispatch",
                          "moves": "serve_rays_per_s", "workloads": ["serve.tiny"]}]
    json.dump(spec, open(root / "BENCHMARK.json", "w"))
    script = ("import sys, time, json; sys.path.insert(0, '.'); from benchmark import harness; "
              "from benchmark import trace as T; "
              "T.from_profiler = lambda prof: T.Trace([], [], (0.0, 1e6)); "
              "print(json.dumps([harness.run('serve.tiny', 5, 0.1, t, time.perf_counter(), "
              "device='cpu') for t in (False, True)]))")
    out = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert plain["correct"] and set(plain["metrics"]) == {"serve_rays_per_s", "setup_s"}
    assert traced["metrics"]["frames_done.serve"]["value"] == 1.0
