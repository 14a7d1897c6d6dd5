#!/usr/bin/env python3
"""K2 (the importance sampler's up-sampling round, ``csrc/up_sample.cu``)
of two checkouts, timed in turns on one card: parent, change, change,
parent.

    python3 scripts/torch_k2_turns.py --parent build/parent

builds each checkout's ``neuralrecon_w_tpu_torch/csrc/up_sample.cu`` alone
with the port's nvcc flags (its ``-Xptxas -v`` lines printed), and times
its ``nw_up_sample`` at the serving path's shapes on 8192 rays (round 0:
8 samples, 8 draws; the last round: 8 + 8 merged, 24 written) and, for
the change only, in the rounds of NeuS's 64 + 64 budget. Inputs are made
from a seed: rays through a sphere of radius 0.5 and its exact sdf. Each
time is taken two ways: in a CUDA graph (``chip_smoke.graph_ms``, the
kernel alone) and as back-to-back calls (``chip_smoke.cuda_ms``, at the
rate the host issues them); beside them the floor, a one-element add in
a CUDA graph. The two checkouts' outputs are held to each other (rays
within 1e-4). Prints the card's name and power limit and one
JSON line; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("neuralrecon_w_tpu_torch", "csrc", "up_sample.cu")
N_RAYS = 8192
Z_ATOL = 1e-4


def build_k2(checkout: str, out_dir: str):
    """nvcc of one checkout's up_sample.cu alone -> (ctypes library, ptxas lines)."""
    sys.path.insert(0, ROOT)
    from chip_smoke import ptxas_report
    from neuralrecon_w_tpu_torch.ops import build

    src = os.path.join(checkout, SRC)
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libk2_{tag}.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(lib)
    dll.nw_up_sample.argtypes = build._SIGNATURES["nw_up_sample"]
    dll.nw_up_sample.restype = ctypes.c_int
    return dll, ptxas_report(proc.stdout + proc.stderr)


def inputs(dev, n0: int):
    import torch

    g = torch.Generator().manual_seed(0)
    o = torch.randn(N_RAYS, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, 0.9])
    d = torch.nn.functional.normalize(-o + torch.randn(N_RAYS, 3, generator=g) * 0.05, dim=-1)
    z = torch.sort(torch.rand(N_RAYS, n0, generator=g) * 1.5 + 0.05, dim=-1).values
    return o.to(dev), d.to(dev), z.to(dev)


def sphere_sdf(o, d, z):
    return (o[:, None] + d[:, None] * z[..., None]).norm(dim=-1) - 0.5


def rounds(dev, n0: int, n_draw: int, up_steps: int, s_base: int):
    """The args of each round, the plain version's outputs fed on."""
    from neuralrecon_w_tpu_torch.ops.importance_sampler import up_sample_round_plain

    o, d, z = inputs(dev, n0)
    out, za, sa, zb, sb = [], z, sphere_sdf(o, d, z), None, None
    for i in range(up_steps):
        last = i + 1 == up_steps
        args = (o, d, za, sa, zb, sb, n_draw, 64.0 * 2 ** (s_base + i), last)
        out.append(args)
        if not last:
            za, sa, zb = up_sample_round_plain(*args)
            sb = sphere_sdf(o, d, zb)
    return out


def caller(dll, args):
    """A call of dll's nw_up_sample on preallocated outputs, and those outputs."""
    import torch

    from neuralrecon_w_tpu_torch.ops.build import stream_handle

    o, d, za, sa, zb, sb, n_draw, inv_s, last = args
    r, na = za.shape
    nb = 0 if zb is None else zb.shape[1]
    n = na + nb
    empty = lambda *shape: torch.empty(*shape, device=za.device)  # noqa: E731
    outs = [empty(r, n + n_draw)] if last else [empty(r, n), empty(r, n), empty(r, n_draw)]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    ptrs = outs + [None] * (3 - len(outs))

    def call():
        err = dll.nw_up_sample(ptr(o), ptr(d), ptr(za), ptr(sa), na, ptr(zb), ptr(sb), nb,
                               n_draw, float(inv_s), int(last), r, ptr(ptrs[0]), ptr(ptrs[1]),
                               ptr(ptrs[2]), stream_handle(za.device))
        if err != 0:
            raise RuntimeError(f"nw_up_sample returned {err}")

    return call, outs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="root of the parent's checkout")
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "k2_turns"))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k2_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, cuda_ms, graph_ms

    dev = torch.device("cuda", 0)
    card = card_line()
    libs = {}
    for label, checkout in (("parent", args.parent), ("change", ROOT)):
        libs[label], ptxas = build_k2(checkout, args.out)
        for line in ptxas:
            print(f"  ptxas {label}: {line}")
    served = rounds(dev, 8, 8, 2, 3)
    cases = {"round 0": served[0], "last": served[1]}
    wide = rounds(dev, 64, 16, 4, 0)
    cases.update({f"64 + 64 round {i}" if i < 3 else "64 + 64 last": a for i, a in enumerate(wide)})
    # the floor: one launch of a one-element add, timed the same way
    one = torch.zeros(1, device=dev)
    floor = [graph_ms(lambda: one.add_(1.0), reps=50) for _ in range(2)]
    print(f"one-element add in a CUDA graph ({card}): {floor[0]:.5f}, {floor[1]:.5f} ms")
    res = {"launch_floor_graph_ms": floor}
    for case, a in cases.items():
        width = a[2].shape[1] + (0 if a[4] is None else a[4].shape[1]) + a[6]
        turns = ("parent", "change", "change", "parent") if width <= 64 else ("change", "change")
        calls = {lab: caller(libs[lab], a) for lab in set(turns)}
        for lab in set(turns):
            calls[lab][0]()
        torch.cuda.synchronize()
        entry = {"width": width}
        if "parent" in calls:
            got, want = calls["change"][1], calls["parent"][1]
            entry["rays_within_parent"] = min(
                ((g - w).abs() <= Z_ATOL).all(dim=1).float().mean().item()
                for g, w in zip(got, want))
        for lab in turns:
            entry.setdefault(lab, {"graph_ms": [], "calls_ms": []})
            entry[lab]["graph_ms"].append(graph_ms(calls[lab][0], reps=50))
            entry[lab]["calls_ms"].append(cuda_ms(calls[lab][0], reps=50))
        res[case] = entry
        print(f"K2 {case} ({width} wide) on {N_RAYS} rays ({card}): " + "; ".join(
            f"{lab} graph {', '.join(f'{t:.5f}' for t in entry[lab]['graph_ms'])} ms, calls "
            f"{', '.join(f'{t:.5f}' for t in entry[lab]['calls_ms'])} ms"
            for lab in dict.fromkeys(turns))
            + (f"; rays within {Z_ATOL} of the parent {entry['rays_within_parent']:.5f}"
               if "rays_within_parent" in entry else ""))
    print(card)
    print(json.dumps({"card": card, "k2_turns": res}))
    bad = [c for c, e in res.items()
           if isinstance(e, dict) and e.get("rays_within_parent", 1.0) < 0.999]
    if bad:
        print(f"change and parent disagree: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
