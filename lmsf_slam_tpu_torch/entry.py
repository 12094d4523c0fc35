"""The flagship step of the port and example arguments for it.

Counterpart of ``__graft_entry__.py::entry()``: ``entry()`` returns one full
tracker iteration (constant-velocity predict → edge/surf Gauss-Newton
registration against the sliding-window local map, its k-NN and projector
kernels on a card → branchless map update) and example arguments on tiny
shapes, on ``device`` (the card by default). The multi-device dry run of that
file waits for the port's ``parallel`` modules.

    python -m lmsf_slam_tpu_torch.entry [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .common.pointcloud import PointBatch
from .ops.registration import RegistrationParams
from .tracker.tracker import TrackerConfig, tracker_init, tracker_step


def entry(device="cuda", seed: int = 0):
    """(fn, example_args): ``fn(state, edge, surf, timestamp)`` runs
    ``tracker_step`` and returns (new state, pose (7,), converged)."""
    device = torch.device(device)
    config = TrackerConfig(
        window=4,
        edge_capacity=256,
        surf_capacity=512,
        registration=RegistrationParams(max_iters=3),
    )

    def fn(state, edge, surf, timestamp):
        new_state, out = tracker_step(state, edge, surf, timestamp, config)
        return new_state, out.pose, out.registration.converged

    rng = np.random.default_rng(seed)

    def cloud(n):
        xyz = torch.as_tensor(rng.standard_normal((n, 3)) * 5.0, dtype=torch.float32,
                              device=device)
        return PointBatch(xyz, torch.ones(n, dtype=torch.bool, device=device))

    example_args = (tracker_init(config, device), cloud(256), cloud(512), 0.1)
    return fn, example_args


def main(argv=None):
    ap = argparse.ArgumentParser(description="run the flagship step once")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, example_args = entry(args.device)
    _, pose, converged = fn(*example_args)
    pose = pose.cpu().numpy()
    if not np.isfinite(pose).all():
        raise SystemExit(f"entry(): non-finite pose {pose}")
    print(f"entry() OK on {args.device}: pose {pose.round(6).tolist()}, "
          f"converged {bool(converged)}")


if __name__ == "__main__":
    main()
