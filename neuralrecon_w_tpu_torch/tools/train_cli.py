"""Training CLI, on the card (``neuralrecon_w_tpu/tools/train_cli.py``;
reference train.py:16-71 + opt.py:3-36).

Usage:
    python -m neuralrecon_w_tpu_torch.tools.train_cli --cfg_path config/train_X.yaml \\
        --exp_name X --num_epochs 20 --batch_size 2048 [--device cpu]

The cfg's DATASET.ROOT_DIR names a phototourism workspace whose ray cache
``prepare_data.prepare_data_cache`` wrote. LR follows the linear-scaling
rule LR = CANONICAL_LR * batch / CANONICAL_BS (reference train.py:21-25)
unless TRAINER.LR is set; resuming with ``--ckpt_path`` (a ``step_<N>.ckpt``
the trainer wrote, or any Lightning-layout ``.ckpt``) and ``--divide_lr``
divides it by ``--lr_divisor``. ``--device`` (default ``cuda``) is where
the model and the step run; ``cpu`` runs the kernels' plain versions, as
the tests do. One card: ``--n_devices``, ``--multihost`` and
``--coordinator`` raise until the multi-GPU item of ROADMAP.md's Queue 1
lands.
"""

from __future__ import annotations

import argparse

MULTI_GPU_ITEM = ("one card only: multi-card and multi-host training is ROADMAP.md "
                  "Queue 1's multi-GPU item")


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=1024)
    parser.add_argument("--test_batch_size", type=int, default=256)
    parser.add_argument("--num_epochs", type=int, default=16)
    parser.add_argument("--ckpt_path", type=str, default=None)
    parser.add_argument("--exp_name", type=str, default="exp")
    parser.add_argument("--save_dir", type=str, default="results")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="optional hard step cap (smoke runs)")
    parser.add_argument("--divide_lr", action="store_true",
                        help="divide LR by --lr_divisor when resuming")
    parser.add_argument("--lr_divisor", type=float, default=5)
    parser.add_argument("--log_every", type=int, default=50,
                        help="steps between scalar logs (each reads the card)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the model trains: cuda (the kernels) or cpu")
    parser.add_argument("--n_devices", type=int, default=-1, help=MULTI_GPU_ITEM)
    parser.add_argument("--multihost", action="store_true", help=MULTI_GPU_ITEM)
    parser.add_argument("--coordinator", type=str, default=None, help=MULTI_GPU_ITEM)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_opts(argv)
    if args.n_devices not in (-1, 1) or args.multihost or args.coordinator is not None:
        raise NotImplementedError(MULTI_GPU_ITEM)

    from ..config import load_cfg
    from ..training.loop import Trainer, TrainerConfig
    from ..training.schedule import scaled_lr

    cfg = load_cfg(args.cfg_path)
    # one process: the world batch is --batch_size (train.py:21-25)
    cfg.TRAINER.TRUE_BATCH_SIZE = args.batch_size
    cfg.TRAINER.LR = scaled_lr(cfg, args.batch_size)
    if args.divide_lr and args.ckpt_path:
        cfg.TRAINER.LR = cfg.TRAINER.LR / args.lr_divisor

    tcfg = TrainerConfig(batch_size=args.batch_size, num_epochs=args.num_epochs,
                         test_batch_size=args.test_batch_size, exp_name=args.exp_name,
                         save_dir=args.save_dir, ckpt_path=args.ckpt_path,
                         log_every=args.log_every)
    trainer = Trainer(cfg, tcfg, device=args.device)
    trainer.fit(max_steps=args.max_steps)
    trainer.logger.close()
    return trainer


if __name__ == "__main__":
    main()
