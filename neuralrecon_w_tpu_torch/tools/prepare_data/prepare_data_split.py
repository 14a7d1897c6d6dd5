"""Split-table CLI, the port's copy of
``neuralrecon_w_tpu/tools/prepare_data/prepare_data_split.py`` (reference
tools/prepare_data/prepare_data_split.py:10-62): view selection by the
scene sphere, the transient filter, then ``<scene>.tsv``. Host code only.

Usage:
    python -m neuralrecon_w_tpu_torch.tools.prepare_data.prepare_data_split \\
        --root_dir <workspace> [--num_test 10]
"""

from __future__ import annotations

import argparse
import os

import yaml


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--num_test", type=int, default=10)
    parser.add_argument("--min_observation", type=int, default=-1)
    parser.add_argument("--roi_threshold", type=float, default=0.5)
    parser.add_argument("--static_threshold", type=float, default=0.6)
    parser.add_argument("--semantic_map_path", type=str, default="semantic_maps")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_opts(argv)
    from .filters import filter_transient, view_selection, write_split_tsv

    with open(os.path.join(args.root_dir, "config.yaml")) as f:
        scene_config = yaml.safe_load(f)

    names = view_selection(
        args.root_dir, scene_config["origin"], scene_config["radius"],
        args.roi_threshold, args.min_observation,
    )
    names = filter_transient(
        args.root_dir, names, args.semantic_map_path,
        static_threshold=args.static_threshold,
    )
    path = write_split_tsv(args.root_dir, names, args.num_test)
    print(f"wrote {path} with {len(names)} images")
    return path


if __name__ == "__main__":
    main()
