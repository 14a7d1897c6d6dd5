#!/usr/bin/env python3
"""K10 (the DDA), K11 (the sampled first hit) and K12 (the two-level DDA,
``csrc/ray_voxel.cu``) of two checkouts, timed in turns on one card
(parent, change, change, parent), and the paths around them.

    python3 scripts/torch_ray_kernel_turns.py --parent build/parent [--kernels-only]
        [--k12-only] [--variants]

builds each checkout's ``neuralrecon_w_tpu_torch/csrc/ray_voxel.cu`` alone
with the port's nvcc flags (its ``-Xptxas -v`` lines printed) and routes
this checkout's wrappers (``ops/ray_voxel.py``) to either build, so that
both kernels run as the path runs them: the same allocations, launch
counts and CUDA graphs, the parent's ``nw_dda`` / ``nw_dda_hier`` called
with its own arguments. Each case is held to the plain version and the
two checkouts to each other (``torch.equal``), and timed in a CUDA graph
(``chip_smoke.graph_ms``, the device alone) and as back-to-back calls
(``chip_smoke.cuda_ms``).

K10 and K11 (unless ``--k12-only``) at ``chip_smoke.ray_kernel_phase``'s
shapes (``ray_kernel_cases``): K10 at the SFM level on one served chunk,
the serving frames and the training cache, at level 10 with first_only
on 2^20 rays; K11 on the steady chunk; K10's pre-pass alone, and each K10
case's share of trips whose global read the mask skipped. Unless
``--kernels-only``, it then builds the whole kernel library and, in
turns, with either checkout's K10 / K11 on this checkout's path: the
served steady frames eager and as the captured graph
(``chip_smoke.serving_graph_phase``, rays/s), the grid-query kernels'
device time on one eager steady chunk (torch.profiler), and the band cache's pass over a device pool
(``DeviceRayPool.attach_surface`` and a synchronise, as
``Trainer.attach_seconds`` times it) of the training cache's 230,400 rows
and of 2^22 rows.

K12 (``k12_turns``): the served field extracted at chip_smoke's level and
at level 10, each made the filter's level-12 grid with its ring views;
first_only on the 4 kernel views' rays of each, on the filter's call
shape (262,144 rays) of the first, and on the first's cloud voxelised
into level-10 and level-11 grids, with the plain version's step split,
reads a ray and warp steps (each warp's longest march, summed); then ``reproj_filter_cli`` over the views under each
checkout's K12 in turns (its DDA seconds and rays/s). This builds the
whole library too (the extraction runs K1 and K6).

With ``--variants``, K10 is also timed in this checkout's VARIANTS (one
constant or line of its source changed: the steps a batch, the block
rule, the mask's level, the level it starts at, no skip) and K12 in
K12_VARIANTS (the mask from level 11 and none, blocks of 256), in turns
with it, each held to the plain version. Prints the card's name and power
limit and one JSON line; exits non-zero without a card, when the
checkouts or a variant disagree, or when a variant does not build.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("neuralrecon_w_tpu_torch", "csrc", "ray_voxel.cu")
ENTRIES = ("nw_coarse_mask", "nw_dda", "nw_sampled_hit", "nw_hier_mask", "nw_dda_hier")
TURNS = ("parent", "change", "change", "parent")
POOL_ROWS = 1 << 22
MESH_10 = 10  # K12's second mesh: the field extracted at level 10
# --variants: this checkout's ray_voxel.cu with one line changed, to read
# what each part of K10's design buys (each must still equal the plain DDA)
VARIANTS = {
    "batch 1": ("constexpr int BATCH = 8;", "constexpr int BATCH = 1;"),
    "batch 4": ("constexpr int BATCH = 8;", "constexpr int BATCH = 4;"),
    "batch 16": ("constexpr int BATCH = 8;", "constexpr int BATCH = 16;"),
    "blocks of 256": ("(n_rays + threads - 1) / threads < 4LL * sms",
                      "(n_rays + threads - 1) / threads < 0LL * sms"),
    "mask level 5": ("constexpr int MASK_LEVEL = 6;", "constexpr int MASK_LEVEL = 5;"),
    "mask from level 7": ("constexpr int MASK_FROM = 9;", "constexpr int MASK_FROM = 7;"),
    "no skip": ("read = (smask[c >> 5] >> (c & 31)) & 1u;", "read = true;"),
}


def constant(name: str, value: int):
    """The variant that sets ray_voxel.cu's ``constexpr int name`` to value."""
    def apply(text: str) -> str:
        new, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         text)
        if n != 1:
            raise ValueError(f"variant: no constexpr int {name} in ray_voxel.cu")
        return new
    return apply


# --variants for K12: this checkout's ray_voxel.cu with one constant or line
# changed, each held to the plain version: the level the mask starts at (11,
# or 13: above every grid here), the launch shape
K12_VARIANTS = {
    "mask from level 11": constant("HIER_MASK_FROM", 11),
    "no mask": constant("HIER_MASK_FROM", 13),
    "blocks of 256": (
        "< 4LL * sms) threads >>= 1;\n  const long long blocks = (n_rays + threads - 1) / threads;"
        "\n  // 32 KB of mask",
        "< 0LL * sms) threads >>= 1;\n  const long long blocks = (n_rays + threads - 1) / threads;"
        "\n  // 32 KB of mask"),
}
# the renderer's grid-query kernels
GRID_KERNELS = ("coarse_kernel", "dda_kernel", "sampled_hit_kernel")


def patched(text: str, variant) -> str:
    """``text`` with ``variant`` applied: an (old, new) pair, a list of
    them, or a function of the text; an old text that is not there raises."""
    if callable(variant):
        return variant(text)
    for old, new in ([variant] if isinstance(variant[0], str) else variant):
        if old not in text:
            raise ValueError(f"variant: no such text in ray_voxel.cu: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_ray_voxel(checkout: str, out_dir: str, variant=None):
    """nvcc of one checkout's ray_voxel.cu alone, with ``variant`` applied
    (``patched``) -> (ctypes library with the checkout's own signatures,
    ptxas lines)."""
    sys.path.insert(0, ROOT)
    from chip_smoke import ptxas_report
    from neuralrecon_w_tpu_torch.ops import build

    spec = importlib.util.spec_from_file_location(
        f"build_{abs(hash(checkout))}", os.path.join(checkout, "neuralrecon_w_tpu_torch", "ops",
                                                     "build.py"))
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    src = os.path.join(checkout, SRC)
    with open(src) as f:
        text = f.read()
    if variant is not None:
        text = patched(text, variant)
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    os.makedirs(out_dir, exist_ok=True)
    if variant is not None:  # beside a copy of the headers it includes
        work = os.path.join(out_dir, f"src_{tag}")
        os.makedirs(work, exist_ok=True)
        for header in glob.glob(os.path.join(os.path.dirname(src), "*.cuh")):
            shutil.copy(header, work)
        src = os.path.join(work, os.path.basename(SRC))
        with open(src, "w") as f:
            f.write(text)
    lib = os.path.join(out_dir, f"libray_voxel_{tag}.so")
    proc = subprocess.run([build._nvcc(), *theirs.NVCC_FLAGS, "-shared", "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(lib)
    for name in ENTRIES:
        if name in theirs._SIGNATURES:
            fn = getattr(dll, name)
            fn.argtypes = theirs._SIGNATURES[name]
            fn.restype = ctypes.c_int
    return dll, set(theirs._SIGNATURES), ptxas_report(proc.stdout + proc.stderr)


class Route:
    """What ``ops/ray_voxel.kernels()`` returns: one checkout's grid-query
    entries, the rest from ``full`` (this checkout's whole library). A
    parent whose nw_dda or nw_dda_hier takes no mask gets its own argument
    list."""

    def __init__(self, dll, names, full=None):
        self.dll, self.names, self.full = dll, names, full

    def __getattr__(self, name):
        if name == "nw_dda" and "nw_coarse_mask" not in self.names:
            fn = self.dll.nw_dda
            return lambda occ, mask, *rest: fn(occ, *rest)
        if name == "nw_dda_hier" and "nw_hier_mask" not in self.names:
            fn = self.dll.nw_dda_hier
            return lambda meta, mask, *rest: fn(meta, *rest)
        if name in ENTRIES:
            return getattr(self.dll, name)
        if self.full is None:
            raise AttributeError(f"{name}: only the grid queries are built (--kernels-only)")
        return getattr(self.full, name)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="root of the parent's checkout")
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "ray_kernel_turns"))
    parser.add_argument("--kernels-only", action="store_true",
                        help="time the kernels only (no whole-library build, no serving path)")
    parser.add_argument("--variants", action="store_true",
                        help="also time K10 in this checkout's VARIANTS and K12 in its "
                             "K12_VARIANTS, in turns with it")
    parser.add_argument("--k12-only", action="store_true",
                        help="K12's cases and the filter CLI only (no K10 / K11)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_ray_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    routes, res = {}, {"card": card}
    for label, checkout in (("parent", args.parent), ("change", ROOT)):
        t0 = time.perf_counter()
        dll, names, ptxas = build_ray_voxel(checkout, args.out)
        routes[label] = Route(dll, names)
        print(f"built {label}'s ray_voxel.cu in {time.perf_counter() - t0:.1f} s")
        for line in ptxas:
            print(f"  ptxas {label}: {line}")
    variants = {**({} if args.k12_only else VARIANTS), **K12_VARIANTS} if args.variants else {}
    for name, variant in variants.items():
        try:
            dll, names, ptxas = build_ray_voxel(ROOT, args.out, variant)
        except RuntimeError as e:  # a variant that does not build is reported, not run
            print(f"  variant {name} did not build: {e}")
            res.setdefault("variants_not_built", []).append(name)
            continue
        routes[name] = Route(dll, names)
        kernel = "dda_hier_kernel" if name in K12_VARIANTS else "dda_kernel"
        print(f"  ptxas {name}: " + "; ".join(p for p in ptxas if f"{kernel}<" in p))

    def use(label):
        rv.kernels = lambda: routes[label]

    use("change")
    bad = [f"variant {name} did not build" for name in res.get("variants_not_built", [])]

    def turns(name, fn, reps):
        """fn() under each checkout in TURNS: graph and back-to-back ms."""
        entry = {lab: {"graph_ms": [], "calls_ms": []} for lab in ("parent", "change")}
        for lab in TURNS:
            use(lab)
            entry[lab]["graph_ms"].append(cs.graph_ms(fn, reps=reps))
            entry[lab]["calls_ms"].append(cs.cuda_ms(fn, reps=reps))
        use("change")
        print(f"{name} ({card}): " + "; ".join(
            f"{lab} graph {', '.join(f'{t:.4f}' for t in entry[lab]['graph_ms'])} ms, calls "
            f"{', '.join(f'{t:.4f}' for t in entry[lab]['calls_ms'])} ms"
            for lab in ("parent", "change")))
        return entry

    def outputs(fn):
        out = {}
        for lab in ("parent", "change"):
            use(lab)
            out[lab] = fn()
        use("change")
        torch.cuda.synchronize()
        return out

    if not args.k12_only:
        bad += k10_k11(cs, rv, args, routes, use, turns, outputs, res, card, dev)
    bad += k12_turns(cs, rv, args, routes, use, turns, outputs, res, card, dev)
    print(card)
    print(json.dumps({"ray_kernel_turns": res}, default=str))
    if bad:
        print(f"disagreements: {bad}", file=sys.stderr)
        return 1
    return 0


def k10_k11(cs, rv, args, routes, use, turns, outputs, res, card, dev) -> list:
    """K10's and K11's cases of chip_smoke.ray_kernel_phase, parent and
    change in turns (K10 also in VARIANTS under --variants), then, unless
    --kernels-only, the serving path and the band cache. Returns the
    disagreements."""
    import torch

    from neuralrecon_w_tpu_torch.config import load_cfg, render_config_from_cfg

    bad = []
    scene, sfm_host, fine_host, frames = cs.make_scene(dev)
    sfm_grid = rv.device_grid_from_host(sfm_host, dev)
    fine_grid = rv.device_grid_from_host(fine_host, dev)
    cfg = load_cfg(cs.CONFIG)
    rcfg_steady = render_config_from_cfg(cfg, sfm_level=sfm_host.level,
                                         fine_level=fine_host.level, nerf_far_override=True)
    k10, k11 = cs.ray_kernel_cases(scene, sfm_grid, sfm_host.level, fine_grid, fine_host,
                                   frames, rcfg_steady)

    for level, grid in ((sfm_host.level, sfm_grid), (fine_host.level, fine_grid)):
        if level < rv.MASK_FROM:  # K10 runs no pre-pass there
            continue
        ms = [cs.graph_ms(lambda: rv.coarse_mask(grid.occ, level), reps=20) for _ in range(2)]
        res[f"prepass level {level}"] = {"graph_ms": ms}
        print(f"K10 pre-pass at level {level} ({card}): graph {ms[0]:.4f}, {ms[1]:.4f} ms")
    for label, grid, level, o, d, first in k10:
        r = o.shape[0]
        steps, reads = (torch.empty(r, dtype=torch.int32, device=dev) for _ in range(2))
        want = rv.dda_traverse_plain(grid.occ, level, o, d, first, steps_out=steps,
                                     global_reads=reads)
        got = outputs(lambda: rv.dda_traverse(grid.occ, level, o, d, first))
        equal = {lab: all(torch.equal(g, w) for g, w in zip(got[lab], want)) for lab in got}
        skipped = 1.0 - float(reads.double().sum()) / max(float(steps.double().sum()), 1.0)
        call = lambda: rv.dda_traverse(grid.occ, level, o, d, first)  # noqa: E731
        reps = 5 if r > 300000 else 20
        entry = turns(f"K10 {label} on {r} rays", call, reps)
        entry.update(rays=r, mean_steps=float(steps.float().mean()), skipped_share=skipped,
                     equal_plain=equal)
        print(f"  equal to the plain version {equal}; the mask skipped {skipped:.4f} of the "
              f"global reads; mean {entry['mean_steps']:.1f} steps")
        if args.variants:
            entry["variants"] = {}
            for name in ("change", *(v for v in VARIANTS if v in routes), "change"):
                use(name)
                ok = all(torch.equal(g, w) for g, w in zip(call(), want))
                ms = cs.graph_ms(call, reps=reps)
                entry["variants"].setdefault(name, []).append(ms)
                bad += [] if ok else [f"K10 {label} {name}"]
            use("change")
            print(f"  variants, graph ms ({card}): " + ", ".join(
                f"{name} {' / '.join(f'{t:.4f}' for t in v)}"
                for name, v in entry["variants"].items()))
        res[f"K10 {label}"] = entry
        bad += [f"K10 {label} {lab}" for lab, ok in equal.items() if not ok]
    grid, level, o, d, t_lo, t_hi, k = k11
    want = rv.sampled_first_hit_plain(grid, level, o, d, t_lo, t_hi, k)
    got = outputs(lambda: rv.sampled_first_hit(grid, level, o, d, t_lo, t_hi, k))
    equal = {lab: all(torch.equal(g, w) for g, w in zip(got[lab], want)) for lab in got}
    call = lambda: rv.sampled_first_hit(grid, level, o, d, t_lo, t_hi, k)  # noqa: E731
    entry = turns(f"K11 at {k} samples on {o.shape[0]} rays", call, 50)
    entry["equal_plain"] = equal
    print(f"  equal to the plain version {equal}")
    res["K11"] = entry
    bad += [f"K11 {lab}" for lab, ok in equal.items() if not ok]

    if not args.kernels_only:
        res["path"], path_bad = serving_and_pool(cs, rv, routes, use, cfg, scene, frames,
                                                 fine_grid, fine_host, sfm_grid, rcfg_steady,
                                                 card)
        bad += path_bad
    return bad


def k12_cases(cs, dev):
    """K12's shapes as chip_smoke runs them: the served field's mesh
    extracted at chip_smoke.EXTRACT_LEVEL and at MESH_10 (``extraction_workspace``,
    ``run_extraction``), each the filter's level-12 grid with its ring views
    (``filter_setup``); the rays of its REPROJ_KERNEL_VIEWS kernel views, and
    on the first also the filter's call shape (``filter_call_rays``) and the
    kernel views' rays through its cloud voxelised at levels 10 and 11 (the
    filter's grids from a coarser voxel_size). Returns ({label: (hg, level, o, d)}, (workspace, cloud ply, voxel size)
    of the first, the workspaces)."""
    import torch

    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg
    from neuralrecon_w_tpu_torch.evaluation import reproj_filter as rf
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv
    from neuralrecon_w_tpu_torch.models.neuconw import init_field

    fc = field_config_from_cfg(load_cfg(cs.CONFIG))
    model = init_field(fc, torch.Generator().manual_seed(cs.SEED), dev).eval()
    model.requires_grad_(False)
    cases, cli, roots = {}, None, []
    for mesh_level in (cs.EXTRACT_LEVEL, MESH_10):
        root = tempfile.mkdtemp(prefix="k12_", dir=os.path.join(ROOT, "build"))
        roots.append(root)
        cfg_path, ckpt, _, fails = cs.extraction_workspace(model, fc, root)
        if fails:
            raise RuntimeError(f"the extraction workspace: {fails}")
        cs.run_extraction(cfg_path, ckpt, mesh_level, "cuda")
        ply = glob.glob(os.path.join(root, "results", "*.ply"))[0]
        _, _, _, cloud, cloud_ply, cams, voxel, grid, hg, _ = cs.filter_setup(root, ply, dev)
        tag = f"level-{mesh_level} mesh, {len(cloud)} points"
        o, d = cs.cloud_rays(cams[:cs.REPROJ_KERNEL_VIEWS], grid, dev)
        cases[f"{tag}, {cs.REPROJ_KERNEL_VIEWS} views"] = (hg, grid.level, o, d)
        if mesh_level == cs.EXTRACT_LEVEL:
            cases[f"{tag}, filter call"] = (hg, grid.level, *cs.filter_call_rays(cams, grid, dev))
            cli = (root, cloud_ply, voxel)
            for level in (10, 11):
                coarse = rf.voxelize_points(cloud, cs.level_voxel(cloud, level))
                assert coarse.level == level, coarse.level
                cases[f"{tag}, level-{level} grid, {cs.REPROJ_KERNEL_VIEWS} views"] = (
                    rv.hier_grid_from_host(coarse, dev), level,
                    *cs.cloud_rays(cams[:cs.REPROJ_KERNEL_VIEWS], coarse, dev))
    return cases, cli, roots


def k12_turns(cs, rv, args, routes, use, turns, outputs, res, card, dev) -> list:
    """K12's cases (``k12_cases``, first_only as the filter asks), each held
    to the plain version and the two checkouts to each other, timed in
    turns (and in K12_VARIANTS under --variants), with the plain version's
    step split and reads; then ``reproj_filter_cli`` in point-cloud mode over
    the ring views under each checkout's K12 in turns: its stages line's
    DDA seconds and rays/s. Returns the disagreements."""
    import contextlib
    import io

    import torch

    from neuralrecon_w_tpu_torch.tools import reproj_filter_cli

    bad = []
    cases, (root, cloud_ply, voxel), roots = k12_cases(cs, dev)
    try:
        for label, (hg, level, o, d) in cases.items():
            r = o.shape[0]
            steps, reads = (torch.zeros(r, dtype=torch.int32, device=dev) for _ in range(2))
            touched = (torch.zeros(hg.meta.shape[0], dtype=torch.int32, device=dev),
                       torch.zeros_like(hg.fine))
            want = rv.dda_traverse_hier_plain(hg, level, o, d, True, touched=touched,
                                              steps_out=steps, global_reads=reads)
            call = lambda: rv.dda_traverse_hier(hg, level, o, d, True)  # noqa: E731
            got = outputs(call)
            equal = {lab: all(torch.equal(g, w) for g, w in zip(got[lab], want)) for lab in got}
            same = all(torch.equal(a, b) for a, b in zip(got["parent"], got["change"]))
            split = cs.k12_split(hg, touched, int(steps.sum()))
            # a warp marches as long as its longest ray (rays in launch order)
            warp_steps = int(torch.nn.functional.pad(steps, (0, -r % 32)).view(-1, 32)
                             .max(1).values.sum())
            entry = turns(f"K12 {label} on {r} rays", call, 20)
            entry.update(rays=r, mean_steps=float(steps.double().mean()),
                         reads_per_ray=float(reads.double().mean()), warp_steps=warp_steps,
                         equal_plain=equal, parent_equals_change=same, **split)
            print(f"  equal to the plain version {equal}, parent to change {same}; mean "
                  f"{entry['mean_steps']:.1f} steps, {split['block_steps']} block and "
                  f"{split['fine_steps']} fine, {split['blocks_entered']} occupied blocks "
                  f"entered, {entry['reads_per_ray']:.2f} reads a ray, {warp_steps} warp steps")
            if args.variants:
                entry["variants"] = {}
                for name in ("change", *(v for v in K12_VARIANTS if v in routes), "change"):
                    use(name)
                    ok = all(torch.equal(g, w) for g, w in zip(call(), want))
                    entry["variants"].setdefault(name, []).append(cs.graph_ms(call, reps=20))
                    bad += [] if ok else [f"K12 {label} {name}"]
                use("change")
                print(f"  variants, graph ms ({card}): " + ", ".join(
                    f"{name} {' / '.join(f'{t:.4f}' for t in v)}"
                    for name, v in entry["variants"].items()))
            res[f"K12 {label}"] = entry
            bad += [f"K12 {label} {lab}" for lab, ok in equal.items() if not ok]
            bad += [] if same else [f"K12 {label}: parent and change differ"]
        del cases
        stages = {"parent": [], "change": []}
        for lab in TURNS:
            use(lab)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                reproj_filter_cli.main(["--src_file", cloud_ply, "--root_dir", root,
                                        "--img_downscale", "1", "--voxel_size", repr(voxel),
                                        "--out_dir", os.path.join(root, f"filtered_{lab}"),
                                        "--device", "cuda"])
            line = next(ln for ln in buf.getvalue().splitlines() if ln.startswith("stages "))
            st = json.loads(line[7:])
            stages[lab].append({"dda_s": st["dda_s"], "dda_calls": st["dda_calls"],
                                "dda_rays_per_s": st["dda_rays"] / st["dda_s"]})
        use("change")
        res["K12 filter CLI"] = stages
        print(f"reproj_filter_cli point-cloud mode, DDA s / rays/s ({card}): " + "; ".join(
            f"{lab} " + ", ".join(f"{e['dda_s']:.4f} s / {e['dda_rays_per_s']:.4g}" for e in v)
            for lab, v in stages.items()))
    finally:
        for root_ in roots:
            shutil.rmtree(root_, ignore_errors=True)
    return bad


def serving_and_pool(cs, rv, routes, use, cfg, scene, frames, fine_grid, fine_host, sfm_grid,
                     rcfg_steady, card):
    """The served steady frames (eager and graph rays/s), the renderer's
    grid-query spans on one eager steady chunk, and the band cache's
    attach, each under the parent's and the change's K10 / K11 in turns."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neuralrecon_w_tpu_torch.config import field_config_from_cfg
    from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool, RayPool
    from neuralrecon_w_tpu_torch.ops import build
    from neuralrecon_w_tpu_torch.models.neuconw import init_field
    from neuralrecon_w_tpu_torch.training.step import make_render_fn

    t0 = time.perf_counter()
    full = build.kernels()
    print(f"built the whole kernel library in {time.perf_counter() - t0:.1f} s")
    for route in routes.values():
        route.full = full
    dev = scene.origin.device
    fc = field_config_from_cfg(cfg)
    model = init_field(fc, torch.Generator().manual_seed(cs.SEED), dev).eval()
    model.requires_grad_(False)
    out, bad = {}, []
    for lab in TURNS:
        use(lab)
        rps, _, fails = cs.serving_graph_phase(model, fc, rcfg_steady, scene, frames, fine_grid,
                                               sfm_grid, f"steady, {lab}'s K10 / K11")
        out.setdefault("serving_rps", {}).setdefault(lab, []).append(rps)
        bad += fails
    rays = torch.as_tensor(frames[1][:cs.CHUNK], device=dev)
    ts = torch.zeros(rays.shape[0], dtype=torch.long, device=dev)
    render = make_render_fn(fc, rcfg_steady)
    for lab in TURNS:
        use(lab)
        render(model, scene, rays, ts, ts, None, fine_grid, sfm_grid)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            render(model, scene, rays, ts, ts, None, fine_grid, sfm_grid)
            torch.cuda.synchronize()
        spans = {}  # a kernel is listed twice: its CPU launch and its device run
        for e in prof.key_averages():
            name = next((n for n in GRID_KERNELS if n in e.key), None)
            if name:
                spans[name] = max(spans.get(name, 0.0), e.device_time_total / 1e3)
        out.setdefault("chunk_device_ms", {}).setdefault(lab, []).append(spans)
        print(f"steady chunk of {rays.shape[0]} rays, {lab}'s K10 / K11 ({card}), device ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(spans.items())))
    rows, rgbs = cs.training_rays()
    for n_rows in (len(rows), POOL_ROWS):
        reps = -(-n_rows // len(rows))
        pool = DeviceRayPool(RayPool(np.tile(rows, (reps, 1))[:n_rows],
                                     np.tile(rgbs, (reps, 1))[:n_rows], seed=0), dev)
        walls = {"parent": [], "change": []}
        for lab in TURNS:
            use(lab)
            pool.attach_surface(fine_grid, fine_host.level)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool.attach_surface(fine_grid, fine_host.level)
            torch.cuda.synchronize()
            walls[lab].append(time.perf_counter() - t0)
        out[f"attach_s {n_rows}"] = walls
        print(f"band cache attach over {n_rows} pool rows at level {fine_host.level} ({card}): "
              + "; ".join(f"{lab} {', '.join(f'{t:.5f}' for t in v)} s"
                          for lab, v in walls.items()))
        del pool
    use("change")
    return out, bad


if __name__ == "__main__":
    sys.exit(main())
