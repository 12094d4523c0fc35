#!/usr/bin/env python3
"""Per-stage profile of the port's front end (``bench_torch.py``'s frame).

``scripts/profile_frontend.py`` through ``lmsf_slam_tpu_torch``: the
benchmark's front end split into its stages — scan simulation (excluded),
range-image organization, feature extraction, the tracking step (register
against the local map, then the map update) — with ``StageTimer`` and,
with ``--trace``, a ``torch.profiler`` trace (``device_trace``). Each stage
runs for every frame, then the card is synchronised once and the stage's time
divided by the frames, as the reference script amortises its stages.

    python3 scripts/profile_frontend_torch.py [--frames 30] [--trace DIR] [--json FILE]
    (--device cpu runs it on the CPU)

Prints the stage table, then one JSON line with the mean frame time and the
device it ran on.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_torch import (  # noqa: E402
    EDGES_PS, N_WARM, RINGS, SECTORS, SURFS_PS, WIDTH, front_end, make_course, make_scan,
    synchronize, tracker_config)

STAGES = ("organize_scan", "extract_features", "tracker_step(register+map)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--trace", default=None, help="torch.profiler trace directory")
    ap.add_argument("--json", default=None, help="write stage stats JSON")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from lmsf_slam_tpu_torch.ops import features as F
    from lmsf_slam_tpu_torch.tracker import tracker_init, tracker_step
    from lmsf_slam_tpu_torch.utils import StageTimer, device_trace

    dev = args.device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        print("profile_frontend_torch: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 1
    n = args.frames
    world, traj = make_course(n + N_WARM)
    scans = [make_scan(world, traj[i], i, RINGS, WIDTH, dev) for i in range(n + N_WARM)]
    config = tracker_config(RINGS, SECTORS, EDGES_PS, SURFS_PS)
    stamps = [torch.tensor(0.1 * i, dtype=torch.float32, device=dev) for i in range(n + N_WARM)]
    state = tracker_init(config, device=dev)
    for i in range(N_WARM):  # kernel builds, map warm-up
        f = front_end(scans[i], RINGS, WIDTH, SECTORS, EDGES_PS, SURFS_PS)
        state, out = tracker_step(state, f.edge, f.surf, stamps[i], config)
    synchronize(dev)

    timer = StageTimer()
    frame_scans = scans[N_WARM:]
    with device_trace(args.trace):
        t0 = time.perf_counter()
        grids = [F.organize_scan(s, rings=RINGS, width=WIDTH) for s in frame_scans]
        synchronize(dev)
        organize = (time.perf_counter() - t0) / n

        t0 = time.perf_counter()
        feats = [F.extract_loam_features(g, sectors=SECTORS, edges_per_sector=EDGES_PS,
                                         surfs_per_sector=SURFS_PS) for g in grids]
        synchronize(dev)
        extract = (time.perf_counter() - t0) / n

        t0 = time.perf_counter()
        for i, f in enumerate(feats):
            state, out = tracker_step(state, f.edge, f.surf, stamps[N_WARM + i], config)
        out.pose.cpu()
        track = (time.perf_counter() - t0) / n
    for _ in range(n):
        for label, seconds in zip(STAGES, (organize, extract, track)):
            timer.add(label, seconds)
        timer.add("total_frame", organize + extract + track)
    print(timer.report())
    s = timer.stats()["total_frame"]
    device = torch.cuda.get_device_name(0) if torch.device(dev).type == "cuda" else "cpu"
    print(json.dumps({
        "frames": n,
        "mean_frame_ms": round(s["mean_ms"], 2),
        "fps": round(1000.0 / s["mean_ms"], 2),
        "device": device,
    }))
    if args.json:
        timer.save_json(args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
