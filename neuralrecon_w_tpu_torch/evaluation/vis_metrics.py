"""Precision / recall / F-score curves of two reconstructions
(``neuralrecon_w_tpu/evaluation/vis_metrics.py``; reference
utils/vis_metrics.py:22-50). matplotlib is imported only where a plot is
drawn: the card's machine has none."""

from __future__ import annotations

import json
import os

import numpy as np


def save_plot(ind, data1, data2, name1, name2, save_path, name):
    """Two curves in percent over the thresholds, written to
    ``save_path/name.png``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.plot(ind, np.array(data1) * 100, "-b", label=name1)
    plt.plot(ind, np.array(data2) * 100, "-r", label=name2)
    plt.legend(loc="upper left")
    plt.title(name)
    plt.xlabel("thresholds(m)")
    plt.ylabel("score")
    plt.ylim(0, 100)
    plt.savefig(os.path.join(save_path, f"{name}.png"))
    plt.clf()


def vis_results(ours_path: str, other_path: str, save_name: str, max_num: int | None = None,
                out_root: str = "eval_results") -> str:
    """One plot per metric of ``ours_path/metrics.json`` (eval_mesh's
    fscores, precs, recals over its thresholds) against ``other_path``'s,
    into ``out_root/save_name``; that directory."""
    with open(os.path.join(ours_path, "metrics.json")) as f:
        ours = json.load(f)
    with open(os.path.join(other_path, "metrics.json")) as f:
        other = json.load(f)
    thresholds = ours.pop("thresholds")[:max_num]
    save_path = os.path.join(out_root, save_name)
    os.makedirs(save_path, exist_ok=True)
    for key in ours:
        save_plot(thresholds, ours[key][:max_num], other[key][:max_num], "ours", "baseline",
                  save_path, key)
    return save_path
