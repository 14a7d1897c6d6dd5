"""Mesh evaluation CLI (``neuralrecon_w_tpu/tools/eval_mesh_cli.py``;
reference utils/eval_mesh.py:126-148, scripts/eval_pipeline.sh:59-82),
numpy and scipy on the host, the same flags and the same metrics.json.

Usage:
    python -m neuralrecon_w_tpu_torch.tools.eval_mesh_cli \
        --file_pred mesh.ply --file_trgt gt.ply --scene_config config.yaml \
        --threshold_start 0.01 --threshold_end 1.0 --threshold_interval 0.01 \
        --sfm_path dense/sparse --track_length 14 --error 2 --voxel_size 2
"""

from __future__ import annotations

import argparse

import numpy as np
import yaml


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--file_pred", type=str, required=True)
    parser.add_argument("--file_trgt", type=str, required=True)
    parser.add_argument("--scene_config", type=str, required=True,
                        help="scene config.yaml path")
    parser.add_argument("--threshold", type=float, default=None)
    parser.add_argument("--threshold_start", type=float, default=None)
    parser.add_argument("--threshold_end", type=float, default=None)
    parser.add_argument("--threshold_interval", type=float, default=None)
    parser.add_argument("--bbx_name", type=str, default="eval_bbx")
    parser.add_argument("--not_mesh", action="store_true")
    parser.add_argument("--save_name", type=str, default="eval")
    parser.add_argument("--sfm_path", type=str, default=None,
                        help="COLMAP dir for SFM-crop filtering")
    parser.add_argument("--track_length", type=int, default=12)
    parser.add_argument("--error", type=float, default=1.5)
    parser.add_argument("--voxel_size", type=float, default=0.1)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_opts(argv)
    from ..evaluation import eval_mesh

    with open(args.scene_config) as f:
        scene_config = yaml.safe_load(f)
    if args.sfm_path:
        scene_config["sfm_path"] = args.sfm_path
        scene_config["eval_tl"] = args.track_length
        scene_config["eval_error"] = args.error
        scene_config["eval_voxel"] = args.voxel_size

    if args.threshold_start is not None:
        thresholds = list(np.arange(
            args.threshold_start,
            args.threshold_end + 1e-9,
            args.threshold_interval,
        ))
    else:
        thresholds = [args.threshold if args.threshold is not None else 0.1]

    res = eval_mesh(
        args.file_pred, args.file_trgt, scene_config,
        is_mesh=not args.not_mesh, threshold=thresholds,
        bbx_name=args.bbx_name, save_name=args.save_name,
    )
    print({k: (v[:3] if isinstance(v, list) else v) for k, v in res.items()})
    return res


if __name__ == "__main__":
    main()
