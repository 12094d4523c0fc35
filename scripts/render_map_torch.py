#!/usr/bin/env python3
"""Render a saved lifelong database to a top-down map + pose-graph PNG.

``scripts/render_map.py`` through ``lmsf_slam_tpu_torch``: the database
checkpoint (either package's ``KeyframeDatabase.save`` writes one the port's
``KeyframeDatabase.load`` reads) booted on the device, drawn by
``evaluation/render.py::render_map`` with the optional estimated and
ground-truth paths on top:

  python3 scripts/render_map_torch.py eval_out_city/city_db.npz --out map.png
  (--device cpu loads the database's mirror on the CPU)

Prints the PNG's path.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("database", help="saved KeyframeDatabase .npz checkpoint")
    ap.add_argument("--out", default="map.png")
    ap.add_argument("--est", default="", help="optional KITTI-format path file")
    ap.add_argument("--gt", default="", help="optional KITTI-format gt file")
    ap.add_argument("--max-points", type=int, default=400_000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from lmsf_slam_tpu_torch.backend import KeyframeDatabase
    from lmsf_slam_tpu_torch.evaluation import load_kitti_trajectory, render_map

    db = KeyframeDatabase.load(args.database, device=args.device)
    est = load_kitti_trajectory(args.est) if args.est else None
    gt = load_kitti_trajectory(args.gt) if args.gt else None
    render_map(
        db, args.out, est=est, gt=gt, max_points=args.max_points,
        title=f"{os.path.basename(args.database)}: {db.n_keyframes} keyframes, "
        f"{db.n_edges} edges",
    )
    print(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
