"""The port's kernel build on the CPU: every ``extern "C"`` entry in
``neuralrecon_w_tpu_torch/csrc/*.cu`` has a ctypes signature in
``ops/build._SIGNATURES`` that matches its C parameter list (ctypes passes
an untyped Python int as a 32-bit int, so a missing or wrong entry cuts a
pointer), and the library's name follows its sources and headers."""

import ctypes
import glob
import os
import re

import pytest

pytest.importorskip("torch")

from neuralrecon_w_tpu_torch.ops import build  # noqa: E402

_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_longlong: "long long", ctypes.c_float: "float",
          ctypes.c_int: "int"}


def c_entries():
    """{name: [kind of each parameter]} of every extern "C" entry."""
    out = {}
    for path in glob.glob(os.path.join(build.CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*\{', src, re.S):
            kinds = []
            for arg in (a.strip() for a in m.group(2).split(",")):
                kinds.append("pointer" if "*" in arg else "long long" if arg.startswith("long long")
                             else arg.split()[0])
            out[m.group(1)] = kinds
    return out


def test_every_entry_has_a_matching_signature():
    entries = c_entries()
    assert {"nw_field_bwd", "nw_bg_fwd", "nw_bg_bwd", "nw_dw_reduce"} <= set(entries)
    assert set(entries) == set(build._SIGNATURES)
    for name, kinds in entries.items():
        assert [_KINDS[t] for t in build._SIGNATURES[name]] == kinds, name


def test_library_name_follows_the_headers(tmp_path, monkeypatch):
    """An edited header (sdf_tile.cuh, color_tile.cuh) renames the library,
    so a stale build is never loaded."""
    for name in ("a.cu", "tile.cuh"):
        (tmp_path / name).write_text("// " + name)
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    before = build.library_path()
    (tmp_path / "tile.cuh").write_text("// edited")
    assert build.library_path() != before
