"""Precision / recall / F-score curves of two evaluated reconstructions
(``neuralrecon_w_tpu/tools/vis_metrics_cli.py``; reference
utils/vis_metrics.py:7-54).

Usage:
    python -m neuralrecon_w_tpu_torch.tools.vis_metrics_cli \\
        --ours_path <dir with metrics.json> --colmap_path <dir with metrics.json> \\
        --save_name <name> [--max_num N]

writes one PNG per metric under ``eval_results/<name>/``. Needs matplotlib.
"""

from __future__ import annotations

import argparse


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--max_num", type=int, default=None)
    parser.add_argument("--ours_path", type=str, required=True)
    parser.add_argument("--colmap_path", type=str, required=True)
    parser.add_argument("--save_name", type=str, required=True)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_opts(argv)
    from ..evaluation import vis_results

    out = vis_results(args.ours_path, args.colmap_path, args.save_name, args.max_num)
    print(f"plots written to {out}")
    return out


if __name__ == "__main__":
    main()
