"""Training CLI, on the card (``neuralrecon_w_tpu/tools/train_cli.py``;
reference train.py:16-71 + opt.py:3-36).

Usage:
    python -m neuralrecon_w_tpu_torch.tools.train_cli --cfg_path config/train_X.yaml \\
        --exp_name X --num_epochs 20 --batch_size 2048 [--device cpu]

The cfg's DATASET.ROOT_DIR names a phototourism workspace whose ray cache
``prepare_data.prepare_data_cache`` wrote. LR follows the linear-scaling
rule LR = CANONICAL_LR * world batch / CANONICAL_BS (reference
train.py:21-25) unless TRAINER.LR is set; resuming with ``--ckpt_path`` (a
``step_<N>.ckpt`` the trainer wrote, or any Lightning-layout ``.ckpt``) and
``--divide_lr`` divides it by ``--lr_divisor``. ``--device`` (default
``cuda``) is where the model and the step run; ``cpu`` runs the kernels'
plain versions, as the tests do.

Data parallelism (``parallel/mesh.py``), one rank per card:

  * ``--n_devices N`` starts N ranks on this host (``-1``: every visible
    card; on the CPU, one), ``--batch_size`` split over them. More than the
    visible cards raises: nothing trains on fewer cards than asked.
  * ``--multihost --coordinator host:port --num_processes P --process_id k``
    runs this CLI once per host: its ranks join one group of P x N ranks
    at ``tcp://host:port``, and the host reads its own share of the cache
    splits. ``--batch_size`` is per process, so the LR's world batch is
    ``batch_size * P`` (JAX ``train_cli.py:86-94``).

NCCL joins ranks on cards, gloo on the CPU. A run of one rank makes no
process group.
"""

from __future__ import annotations

import argparse


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
    parser.add_argument("--n_devices", type=int, default=-1,
                        help="ranks on this host, one card each; -1 = every visible card "
                             "(on the CPU, one)")
    parser.add_argument("--multihost", action="store_true",
                        help="join a group across processes (run once per host) at "
                             "--coordinator, with --num_processes and --process_id")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of the group's rendezvous (with --multihost)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser.parse_args(argv)


def local_ranks(n_devices: int, device: str) -> int:
    """The ranks this host runs: ``--n_devices`` checked against the visible
    cards (on a card), -1 resolved."""
    import torch

    if n_devices == 0 or n_devices < -1:
        raise ValueError(f"--n_devices {n_devices}: a count of ranks, or -1")
    if torch.device(device).type != "cuda":
        return max(n_devices, 1)
    visible = torch.cuda.device_count()
    if n_devices == -1:
        return max(visible, 1)
    if n_devices > 1 and n_devices > visible:
        raise ValueError(f"--n_devices {n_devices}: this host has {visible} visible CUDA "
                         f"card(s); one rank per card")
    return n_devices


def run(args, group=None):
    """The Trainer of ``args`` (parsed), as a rank of ``group`` where given;
    trained. Returns it."""
    from ..config import load_cfg
    from ..training.loop import Trainer, TrainerConfig
    from ..training.schedule import scaled_lr

    cfg = load_cfg(args.cfg_path)
    # --batch_size is per process: the world batch counts processes, not
    # the ranks that split a process's batch (train.py:21-25)
    world_batch = args.batch_size * (1 if group is None else group.num_processes)
    cfg.TRAINER.TRUE_BATCH_SIZE = world_batch
    cfg.TRAINER.LR = scaled_lr(cfg, world_batch)
    if args.divide_lr and args.ckpt_path:
        cfg.TRAINER.LR = cfg.TRAINER.LR / args.lr_divisor

    tcfg = TrainerConfig(batch_size=args.batch_size, num_epochs=args.num_epochs,
                         test_batch_size=args.test_batch_size, exp_name=args.exp_name,
                         save_dir=args.save_dir, ckpt_path=args.ckpt_path,
                         log_every=args.log_every)
    trainer = Trainer(cfg, tcfg, device=args.device, group=group)
    trainer.fit(max_steps=args.max_steps)
    trainer.logger.close()
    return trainer


def main(argv=None):
    """Train; returns the Trainer when this process runs the only rank or
    its host's one rank, else None (the ranks ran in spawned processes)."""
    args = get_opts(argv)
    n_local = local_ranks(args.n_devices, args.device)
    num_processes, process_id, coordinator = 1, 0, None
    if args.multihost:
        missing = [f for f in ("coordinator", "num_processes", "process_id")
                   if getattr(args, f) is None]
        if missing:
            raise ValueError("--multihost needs " + ", ".join("--" + f for f in missing))
        num_processes, process_id, coordinator = (args.num_processes, args.process_id,
                                                  args.coordinator)
    elif args.coordinator or args.num_processes or args.process_id is not None:
        raise ValueError("--coordinator, --num_processes and --process_id go with --multihost")

    if num_processes * n_local == 1:
        return run(args)
    from ..parallel.mesh import free_coordinator, run_rank, spawn

    # a rank's card is card local_rank (the group's default); CPU ranks say so
    device = "cpu" if args.device == "cpu" else None
    if n_local == 1:
        return run_rank(0, run, args, 1, num_processes, process_id, coordinator, None, device)
    spawn(run_rank, n_local, (run, args, n_local, num_processes, process_id,
                              coordinator or free_coordinator(), None, device))
    return None


if __name__ == "__main__":
    main()
