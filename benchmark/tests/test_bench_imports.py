"""Nothing the benchmark runs imports JAX or the JAX package: every module
under ``benchmark/`` parsed (top-level names compared whole, so the port,
``neuralrecon_w_tpu_torch``, passes), and a whole run's ``sys.modules``
checked as ``run.py`` checks it."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from benchmark import harness

from conftest import ROOT

FILES = sorted(glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"), recursive=True))


def imported(path: str) -> list:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_module_imports_nothing_of_jax(path):
    assert harness.forbidden_modules(imported(path)) == []


def test_names_are_compared_whole():
    assert harness.forbidden_modules(["neuralrecon_w_tpu_torch.ops", "jaxtyping", "flaxen",
                                      "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                                      "neuralrecon_w_tpu.models"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "neuralrecon_w_tpu.models"]


def test_a_run_loads_nothing_of_jax():
    """A tiny run of each kind in a fresh interpreter, then its sys.modules."""
    script = ("import sys, time; sys.path.insert(0, 'benchmark/tests'); "
              "from conftest import tiny_run; tiny_run('train.op'); tiny_run('serve.op'); "
              "from benchmark import harness; print(harness.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """Without CUDA the command prints no result and exits non-zero."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "train.op",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
