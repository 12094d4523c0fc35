"""Readings of the program and of the control on the same runs.

    python3 benchmark/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell as ``run.py`` makes it (set-up, a window
of ``--seconds``, the check), in one process; its result line gains
``control``: the check's numbers with the plain reference, its clouds,
poses, IMU windows and filter states stored in bfloat16 and its arithmetic
in float32, put in the system's place. A limit lies between the largest reading of the program and the
smallest of the control.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import run  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    rc = 0
    for seed in args.seeds:
        rc |= run(["--workload", args.workload, "--seed", str(seed), "--seconds", str(args.seconds),
                   "--trace", "0"], time.perf_counter(), control=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
