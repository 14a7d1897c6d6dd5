"""On a card: the command itself, a short run of each cell, its last line
as the contract has it. Skips without CUDA (the ``card`` fixture)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.spec()["workloads"]])
def test_a_short_run_of_the_cell(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "4000000007", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
