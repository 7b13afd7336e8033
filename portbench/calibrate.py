"""Readings that set a cell's limits: the program's compared numbers over
many seeds (the lower readings) and the reference's stand-ins' on the same
samples (the upper readings: the fp8 control, and in the BO cells a loop
that takes its draws in place of GP-EI), in one process on the card.

    python3 portbench/calibrate.py --workload r101.window-1024 --seconds 3 --seeds 101 102 103

Each seed is a whole run (its own weights, pool and window) with the
stand-ins read beside the program. One JSON line per seed, with whether the
cell's committed limits pass each side (``verdicts``: the program's has to
be true, every stand-in's false); then the largest program reading, the
smallest reading of each stand-in, and the seeds on which a verdict came
out wrong. Not part of the benchmark's own runs."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# One process with few threads: the host's numerical libraries run on one
# thread each, as the card's single caller needs (set before numpy loads).
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    from portbench import harness
    from portbench.spec import Cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    lower, upper, wrong = {}, {}, []
    for seed in args.seeds:
        t = time.perf_counter()
        out = harness.run(cell, seed, args.seconds, False, t, control=True)
        r, verdicts = out["readings"], out["verdicts"]
        print(json.dumps({"seed": seed, "images": out["images"], "window_s": out["window_s"],
                          "setup_s": out["setup_s"], "check_s": out["check_s"],
                          "metrics": out["line"]["metrics"], "correct": out["line"]["correct"],
                          "verdicts": verdicts, "readings": r, "notes": out["notes"]}),
              flush=True)
        for k, v in r["program"].items():
            lower[k] = max(lower.get(k, v), v)
        for side, nums in r.items():
            if side != "program":
                got = upper.setdefault(side, {})
                for k, v in nums.items():
                    got[k] = min(got.get(k, v), v)
        stand_ins = [v for side, v in verdicts.items() if side != "program"]
        if not out["line"]["correct"] or any(stand_ins):
            wrong.append(seed)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds), "lower": lower,
                      "upper": upper, "limits": cell.limits, "wrong_verdicts": wrong}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
