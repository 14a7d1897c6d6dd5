"""The numbers that decide ``correct``: what the timed path produced against
the plain reference. A cell's file (``benchmark/workloads/<cell>.json``)
names the numbers it compares, each with its limit and the readings the
limit was set from; the others are printed beside them and not judged.

Training, over the first steps that set-up drove through the window's own
call:

* ``loss_gap``: the widest relative gap of a step's loss; ``loss_first_gap``
  the first step's alone; ``color_term_gap``, ``eikonal_term_gap``,
  ``mask_term_gap``, ``depth_term_gap``: the widest relative gap of a
  step's loss term (the step's aux: the colour L1, the eikonal term, the
  sky mask's BCE, the SFM depth term);
* ``grad_gap``: the first gradient as the optimiser got it (the program's
  from Adam's first moment after one step, m / (1 - b1)), by the worst
  leaf: the gap between the two norms over the larger of the reference's
  norm of that leaf and of the median leaf; ``grad_median_gap`` the median
  of the leaves' gaps;
* ``change_gap``: the parameters' change over the steps, by the worst leaf
  in the same measure, leaving out the leaves whose reference gradient is
  under a thousandth of the median leaf's (round-off alone moves them under
  Adam); ``change_median_gap`` the median of the leaves' gaps;
* ``grad_dir_gap``, ``grad_dir_median_gap``, ``change_dir_gap``,
  ``change_dir_median_gap``: the same four with the norm of the difference
  in place of the gap between the norms, over the reference's norm of that
  leaf alone, and for the gradient too over the leaves the change keeps: a
  gradient that points elsewhere at the same length (rows left out) reads
  here, most in the small leaves of the appearance codes, which the median
  leaf's norm would hide;
* ``rows_off``: the rows of the steps' batches that differ from the epoch
  permutation the pool's seed rule gives (an exact number).

Serving, over a seeded sample of the rays of frames the window finished:
``color_gap``, the mean absolute gap of a ray's colour channels;
``depth_gap``, the mean absolute gap of the depth (unit-sphere units)."""

from __future__ import annotations

import math

import torch

ROUNDOFF_LEAF = 1e-3
# each loss term's number and the step aux it reads
TERMS = {"color_term_gap": "color_loss", "eikonal_term_gap": "normal_loss",
         "mask_term_gap": "mask_error", "depth_term_gap": "sfm_depth_loss"}


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's gap between the norms, over the larger of the reference
    norm of that leaf and of the median leaf."""
    pn, rn = _norms({k: prog[k] for k in keys}), _norms({k: ref[k] for k in keys})
    med = sorted(rn.values())[len(rn) // 2]
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def leaf_dir_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's norm of the difference over the reference's norm of that
    leaf."""
    rn = _norms({k: ref[k] for k in keys})
    return {k: float(torch.linalg.vector_norm(prog[k].double() - ref[k].double()))
            / max(rn[k], 1e-30) for k in keys}


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2]


def kept_leaves(ref_grads: dict) -> list:
    rg = _norms(ref_grads)
    med = _median(rg.values())
    return [k for k in ref_grads if rg[k] >= ROUNDOFF_LEAF * med]


def _step_gaps(prog: list, ref: list, term: str) -> list:
    return [abs(a[term] - b[term]) / max(abs(b[term]), 1e-30) for a, b in zip(prog, ref)]


def train_numbers(prog: dict, ref: dict, params0: dict) -> dict:
    """prog / ref: {"losses": [each step's {term: value}], "grads": {leaf:
    tensor}, "params": {leaf: tensor after the steps}, "idx": [each step's
    rows]}; params0 the weights they started from."""
    gaps = _step_gaps(prog["losses"], ref["losses"], "loss")
    terms = {name: max(_step_gaps(prog["losses"], ref["losses"], term))
             for name, term in TERMS.items() if term in ref["losses"][0]}
    out = {"loss_gap": max(gaps), "loss_first_gap": gaps[0], **terms}
    for measure, suffix in ((leaf_gaps, ""), (leaf_dir_gaps, "_dir")):
        for name, d in zip(("grad", "change"), _leaf_maps(prog, ref, params0, measure)):
            out[f"{name}{suffix}_gap"] = max(d.values())
            out[f"{name}{suffix}_median_gap"] = _median(d.values())
    out["rows_off"] = float(sum(int((a.cpu() != b.cpu()).sum())
                                for a, b in zip(prog["idx"], ref["idx"])))
    return out


def _leaf_maps(prog: dict, ref: dict, params0: dict, measure=leaf_gaps) -> tuple:
    """Each leaf's gap of the first gradient (every leaf, or with
    ``leaf_dir_gaps`` the kept ones) and of the change (the kept ones)."""
    kept = kept_leaves(ref["grads"])
    grad = measure(prog["grads"], ref["grads"], kept if measure is leaf_dir_gaps
                   else list(ref["grads"]))
    change = measure({k: prog["params"][k].double() - params0[k].double() for k in kept},
                     {k: ref["params"][k].double() - params0[k].double() for k in kept}, kept)
    return grad, change


def worst_leaves(prog: dict, ref: dict, params0: dict, top: int = 3) -> dict:
    """The leaves behind ``grad_gap``, ``change_gap`` and their ``_dir``
    numbers, largest first."""
    return {f"{name}{suffix}": sorted(d.items(), key=lambda kv: -kv[1])[:top]
            for measure, suffix in ((leaf_gaps, ""), (leaf_dir_gaps, "_dir"))
            for name, d in zip(("grad", "change"), _leaf_maps(prog, ref, params0, measure))}


def serve_numbers(color, depth, ref_color, ref_depth) -> dict:
    """color (N, 3), depth (N,) of the program and the reference."""
    dc = (color.double() - ref_color.double()).abs()
    dd = (depth.double() - ref_depth.double()).abs()
    return {"color_gap": float(dc.mean()), "depth_gap": float(dd.mean())}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number the limits name present, finite and within its limit;
    no limits at all fails."""
    return bool(limits) and all(k in numbers and math.isfinite(numbers[k])
                                and numbers[k] <= v for k, v in limits.items())
