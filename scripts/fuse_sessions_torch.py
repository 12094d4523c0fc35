#!/usr/bin/env python3
"""Multi-session map fusion at city scale through the port.

``scripts/fuse_sessions.py`` run through ``lmsf_slam_tpu_torch``: two
independently-mapped sessions (saved lifelong databases) are fused into one
pose graph — appearance alignment (scan-context relocalization of B inside
A) → merge with verified inter-session edges → a full solve (the submap
Schur solve past 192 keyframes) → fused ATE against the course's ground
truth, the fused database and, where matplotlib imports, the fused map.

Produce the inputs with two offset runs of the city evaluation, e.g.:

  python scripts/evaluate_torch.py --dataset city --sync --frames 900 \\
      --save-db /tmp/sess_a.npz --out eval_A
  python scripts/evaluate_torch.py --dataset city --sync --start 800 \\
      --save-db /tmp/sess_b.npz --out eval_B
  python scripts/fuse_sessions_torch.py /tmp/sess_a.npz /tmp/sess_b.npz --out eval_fused_torch

Both packages read each other's checkpoints. ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("db_a")
    ap.add_argument("db_b")
    ap.add_argument("--out", default="eval_fused_torch")
    ap.add_argument("--min-matches", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from lmsf_slam_tpu_torch.backend import (
        KeyframeDatabase, LifelongBackend, LifelongConfig, LoopConfig, align_sessions,
        merge_sessions)
    from lmsf_slam_tpu_torch.common import se3np
    from lmsf_slam_tpu_torch.datasets import make_city_course
    from lmsf_slam_tpu_torch.evaluation import ate_stats

    db_a = KeyframeDatabase.load(args.db_a, device=args.device)
    db_b = KeyframeDatabase.load(args.db_b, device=args.device)
    n_a, n_b = db_a.n_keyframes, db_b.n_keyframes

    loop_cfg = LoopConfig(min_frame_interval=0, exclude_recent=0, search_radius=8.0,
                          adjacent_window=4)
    align = align_sessions(db_a, db_b, loop_cfg, min_matches=args.min_matches)
    if align is None:
        print(json.dumps({"fused": False, "reason": "alignment failed"}))
        return 1
    merge_sessions(db_a, db_b, align)  # appends B into A in place
    merged = db_a

    backend = LifelongBackend(db=merged, config=LifelongConfig(schur_submaps=16,
                                                               schur_min_vertices=192))
    stats = backend.optimize(full=True)

    # ground truth: keyframe stamps are on the absolute course clock
    # (frame = stamp / 0.1), in session A's map frame (= course[start_a])
    course = make_city_course()
    frames = np.clip(np.round(merged.stamps[:merged.n_keyframes] / 0.1).astype(int),
                     0, course.shape[0] - 1)
    gt = np.stack([se3np.pose_between(course[frames[0]], course[f]) for f in frames])
    est = merged.map_poses[:merged.n_keyframes]
    s = ate_stats(est, gt)

    os.makedirs(args.out, exist_ok=True)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        pass
    else:
        from lmsf_slam_tpu_torch.evaluation import render_map

        render_map(merged, os.path.join(args.out, "fused_map.png"),
                   title=f"fused sessions: {n_a}+{n_b} keyframes, "
                   f"{len(align.matches)} inter-session edges")
    merged.save(os.path.join(args.out, "fused_db.npz"))
    out = {
        "fused": True,
        "keyframes_a": int(n_a),
        "keyframes_b": int(n_b),
        "inter_session_edges": len(align.matches),
        "align_transform_trans_m": [round(float(x), 3) for x in align.transform[4:]],
        "fused_ate": {"rmse": round(s.rmse, 4), "mean": round(s.mean, 4),
                      "max": round(s.max, 4)},
        "chi2": [float(stats.chi2_initial), float(stats.chi2_final)] if stats else None,
        "solver_runs": dict(backend.solver_runs),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
