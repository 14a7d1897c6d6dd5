"""The benchmark's driver: finds a cell's configuration, traffic and metrics
by the names in ``BENCHMARK.json``, runs the traffic's kind, reads the
per-layer metrics from the trace and judges ``correct``.

Files, each found by name (a new one is picked up without an edit here):

* ``configs/<config>.json``: the configuration as it is run: the port's
  cfg sections (NEUCONW, TPU, TRAINER), its dtype, the scene it assumes;
* ``traffic/<traffic>.json``: a traffic mix, the parameters of one kind;
* ``traffic/<kind>.py``: a kind's generator and window (``run(ctx)``);
* ``metrics/<metric>.py``: a per-layer metric's reader (``read(rec)``,
  None where it finds nothing to read);
* ``workloads/<cell>.json``: the cell's correctness limits and the
  readings they were set from.

A kind's ``run(ctx)`` returns {"attempted", "failed", "numbers" (the
comparison with the reference), "memory_peak_bytes", and "e2e" (the
end-to-end values, untraced) or "rec" (what the per-layer readers take,
traced)}."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time

import torch

from . import correct

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "neuralrecon_w_tpu")  # top-level names, compared whole
STREAMS = {"weights": 1, "scene": 2, "rows": 3, "frames": 4, "sample": 5}


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(sp: dict, name: str) -> dict:
    for w in sp["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return read_json(os.path.join(BENCH, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return read_json(os.path.join(BENCH, "traffic", f"{name}.json"))


def cell_file(name: str) -> dict:
    return read_json(os.path.join(BENCH, "workloads", f"{name}.json"))


def kind(name: str):
    return importlib.import_module(f"{__package__}.traffic.{name}")


def reader(metric: str):
    """The reader module of a per-layer metric (its file name may hold dots)."""
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    s = importlib.util.spec_from_file_location(f"{__package__}.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def end_to_end_for(sp: dict, cell: str) -> list:
    return [m for m in sp["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_for(sp: dict, cell: str) -> list:
    e2e = {m["name"] for m in end_to_end_for(sp, cell)}
    return [m for m in sp["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def forbidden_modules(modules) -> list:
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def merged(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys set, nested dicts merged (tests shrink
    a configuration or a traffic mix this way)."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _set_tree(node, over: dict) -> None:
    for k, v in over.items():
        if isinstance(v, dict):
            _set_tree(node[k], v)
        else:
            node[k] = tuple(v) if isinstance(node[k], tuple) else v


class Context:
    """What a traffic kind gets: the cell's configuration (the file's dict
    and the port's cfg tree), its traffic parameters and limits, the seed,
    the window's length, whether to trace, the device, and the clock."""

    def __init__(self, cell: str, wl: dict, seed: int, seconds: float, trace: bool, device,
                 t_start: float, cfg_over: dict | None = None, traffic_over: dict | None = None):
        from neuralrecon_w_tpu_torch.config import load_cfg

        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.cfg = merged(config(wl["config"]), cfg_over)
        self.port_cfg = load_cfg(os.path.join(BENCH, "configs", f"{wl['config']}.json"))
        _set_tree(self.port_cfg, {k: v for k, v in (cfg_over or {}).items()
                                  if k in ("NEUCONW", "TPU", "TRAINER")})
        self.traffic = merged(traffic(wl["traffic"]), traffic_over)
        cf = cell_file(cell)
        self.limits = cf.get("limits", {})
        self.control = cf.get("control")  # the precision of the cell's control
        # the program's own seeds (its generators' streams are seeded from
        # them times ~1e6, so they stay under 2^31)
        self.prog_seed = self.seed % (2 ** 31 - 1)
        self.setup_s = None
        self._lap = t_start
        self.lap("imports")

    def lap(self, what: str) -> None:
        """Seconds since the previous lap, on standard error (where set-up
        and the check spend their time)."""
        now = time.perf_counter()
        print(f"{self.cell}: {what} {now - self._lap:.2f} s", file=sys.stderr)
        self._lap = now

    def walls(self, what: str, marks: list) -> None:
        """The seconds between consecutive marks of the window, on standard
        error (the window's own spread)."""
        print(f"{self.cell}: {what} " + " ".join(f"{b - a:.4f}" for a, b in zip(marks, marks[1:])),
              file=sys.stderr)

    def generator(self, stream: str) -> torch.Generator:
        s = (self.seed * 1_000_003 + STREAMS[stream]) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(s)

    def window_started(self) -> None:
        self.lap("set-up's last part")
        self.setup_s = time.perf_counter() - self.t_start

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def device_info(device, chips: int, memory_peak: int) -> dict:
    dev = torch.device(device)
    kind_ = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind_, "count": chips,
            "memory_peak_bytes": int(memory_peak)}


def run(cell: str, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
        cfg_over: dict | None = None, traffic_over: dict | None = None) -> dict:
    """One run of ``cell``: the result line's dict, ``check`` last."""
    sp = spec()
    wl = workload(sp, cell)
    ctx = Context(cell, wl, seed, seconds, trace, device, t_start, cfg_over, traffic_over)
    out = kind(ctx.traffic["kind"]).run(ctx)
    numbers = out["numbers"]
    ok = correct.judge(numbers, ctx.limits) and out["failed"] == 0
    metrics = {}
    dev = device_info(device, wl["chips"], out["memory_peak_bytes"])
    result = {"correct": ok, "attempted": out["attempted"], "failed": out["failed"]}
    if not trace:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in end_to_end_for(sp, cell):
            v = values[m["name"]]
            if not (v is not None and math.isfinite(v) and v > 0):
                raise RuntimeError(f"{cell}: end-to-end metric {m['name']} read {v}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        from . import trace as T

        rec = dict(out["rec"], cfg=ctx.cfg)
        for m in per_layer_for(sp, cell):
            v = reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = rec["trace"]
        dev.update(busy_s=T.busy_seconds(tr), window_s=T.window_seconds(tr))
        result["breakdown"] = {"device_ops": T.top_ops(tr), "idle_gaps": T.idle_gaps(tr)}
    result["metrics"] = metrics
    result["device"] = dev
    result["check"] = {k: {"value": numbers.get(k), "limit": v} for k, v in ctx.limits.items()}
    return result
