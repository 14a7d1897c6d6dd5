#!/usr/bin/env python3
"""One run of a cell of the port's benchmark on the CUDA card(s) of this
machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's inputs and weights from
the seed, warms up (the kernel library is built into the checkout's
``build/`` on its first run there), measures for ``--seconds`` (``--trace
1``: traces one dispatch or a few frames instead, for the per-layer
metrics), holds what the timed path produced to the plain reference, and
prints as its last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check`` (each number compared with its limit),
which also closes standard error. Without a card, with fewer cards than
the cell asks for, or with JAX or the JAX package loaded, it prints no
result and exits with another code than 0."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of a cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, ROOT)
    from benchmark import harness

    chips = harness.workload(harness.spec(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    # the program runs as its configuration states: float32 products in
    # float32 (TF32 off, torch's default for products)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    leaked = harness.forbidden_modules(sys.modules)
    if leaked:
        print(f"benchmark: the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
