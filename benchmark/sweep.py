"""Sweep the offered rate of an open-loop cell to find the highest rate the
system sustains:

    python3 benchmark/sweep.py --workload <name> --seed <n> --seconds <s> --rates <r> [<r> ...]
        [--root <checkout>]

One process: the cell's set-up once, then for each rate a new system serves
frames 0 .. rate × seconds of the course at that rate. A rate is sustained
while the latency from the due time does not grow through the window (the
last quarter's median within 1.5 × the first quarter's, p95 under 1 s). The
rate the cell offers is then set by hand in its traffic file.
"""
import argparse
import json
import os
import statistics
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--root", default=str(harness.ROOT),
                    help="the checkout whose BENCHMARK.json names the cell")
    args = ap.parse_args()
    import torch

    from benchmark import sut, traffic as traffic_mod

    cell, config, mix, _, _, _, _ = harness.load_spec(args.workload, Path(args.root))
    device = torch.device("cuda:0")
    n_max = int(max(args.rates) * args.seconds) + 1
    tr = traffic_mod.Traffic(mix, config["sensor"], args.seed, device, n_max)
    pool = [tr.frame(k) for k in range(n_max)]
    with tempfile.TemporaryDirectory(prefix="sweep-") as tmp:
        warm = sut.build(config, device, os.path.join(tmp, "warm"))
        sut.seed_velocity(warm, tr.initial_velocity())
        for k in range(mix.get("warmup_frames", 3)):
            sut.process(warm, pool[k], tr.stamp(k))
        warm.flush()
        sut.warm_solver(warm)
        sut.close(warm)
        for i, rate in enumerate(args.rates):
            system = sut.build(config, device, os.path.join(tmp, f"r{i}"))
            sut.seed_velocity(system, tr.initial_velocity())
            n = int(rate * args.seconds)
            w = harness.open_window(sut, system, tr, pool[:n], rate)
            sut.close(system)
            lat = w["latency_s"]
            q = max(1, n // 4)
            first, last = statistics.median(lat[:q]), statistics.median(lat[-q:])
            row = {"rate_fps": rate, "frames": n, **harness.latency_stats(lat),
                   "first_quarter_p50_ms": 1e3 * first, "last_quarter_p50_ms": 1e3 * last,
                   "served_fps": n / w["window_s"], "backlog_peak": max(w["backlog"]),
                   "sustained": last <= 1.5 * first and harness.quantile(lat, 0.95) < 1.0}
            print(json.dumps(row), flush=True)
            del system
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
