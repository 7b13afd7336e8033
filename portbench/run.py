"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 portbench/run.py --workload r101.window-1024 --seed 7 --seconds 10 --trace 0

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks`` last: each number compared with its limit). The
last lines of standard error repeat the checks. Without a card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded, it prints
no result and exits non-zero."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# One process with few threads: the host's numerical libraries run on one
# thread each, as the card's single caller needs (set before numpy loads).
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT   # the checkout's root, not this folder: its module names are not top-level


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness
    from portbench.spec import Cell

    found = harness.forbidden_modules(extra=(harness.PORT,))
    if found:
        print(f"portbench: the harness and the reference loaded {found}", file=sys.stderr)
        return 3
    import torch

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    return harness.report(out)


if __name__ == "__main__":
    sys.exit(main())
