"""The flagship step of the port, example arguments for it, and the
multi-device dry run.

Counterpart of ``__graft_entry__.py``: ``entry()`` returns one full tracker
iteration (constant-velocity predict → edge/surf Gauss-Newton registration
against the sliding-window local map, its k-NN and projector kernels on a
card → branchless map update) and example arguments on tiny shapes, on
``device`` (the card by default). ``dryrun_multichip(n)`` runs one full
sharded SLAM step over a mesh of n ranks: frame registration over the mesh,
the edge-sharded pose-graph solve, and the submap Schur solve sharded over
the same mesh with the per-edge robust policy active.

    python -m lmsf_slam_tpu_torch.entry [--device cuda]
    python -m lmsf_slam_tpu_torch.entry --dryrun [--device cuda|cpu]

With ``--dryrun`` every rank of the launch runs it: under
``torchrun --nproc-per-node N`` or with the ``LMSF_*`` variables of
:mod:`.parallel.multihost`, or alone as a world of one.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .backend.pose_graph import PoseGraphParams
from .common import se3np
from .common.pointcloud import PointBatch
from .ops.registration import RegistrationParams
from .parallel import make_mesh, multihost, optimize_pose_graph_schur, slam_training_step
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


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One full sharded SLAM step on a mesh of ``n_devices`` ranks (a world of
    one without a process group): F = max(n, 2) frames of 64 / 128 random
    points through ``slam_training_step``, a 16-vertex ring through the
    edge-sharded solve, and a 128-vertex drifted chain with two robust loop
    edges through ``optimize_pose_graph_schur(n_submaps=2n, mesh=)``. Raises
    unless the poses are finite and the Schur solve lowers chi2. Returns the
    chi2 of both solves."""
    mesh = make_mesh(n_devices, axis="data", backend="cpu" if device == "cpu" else None)
    dev = mesh.device
    F = max(n_devices, 2)  # frames, sharded over the mesh
    N, M = 64, 128
    rng = np.random.default_rng(0)

    def batch(n):
        return PointBatch(torch.as_tensor(rng.standard_normal((F, n, 3)) * 4.0,
                                          dtype=torch.float32, device=dev),
                          torch.ones((F, n), dtype=torch.bool, device=dev))

    frames = {"src_edge": batch(N), "src_surf": batch(N), "map_edge": batch(M),
              "map_surf": batch(M),
              "init_poses": torch.as_tensor(np.tile(se3np.pose_identity(), (F, 1)),
                                            dtype=torch.float32, device=dev)}

    # a ring, its edges sharded over the same mesh
    V = 16
    step = se3np.se3_exp(np.array([0, 0, 2 * np.pi / V, 1.0, 0, 0]))
    ring = [se3np.pose_identity()]
    for _ in range(V - 1):
        ring.append(se3np.pose_compose(ring[-1], step))
    ring = np.stack(ring)
    eij = np.array([(i, (i + 1) % V) for i in range(V)], np.int32)
    graph = {
        "poses": torch.as_tensor(ring, dtype=torch.float32, device=dev),
        "vmask": np.ones(V, bool), "edges_ij": eij,
        "edges_z": np.float32(se3np.pose_between(ring[eij[:, 0]], ring[eij[:, 1]])),
        "edges_sqrtw": np.ones((V, 6), np.float32), "emask": np.ones(V, bool),
    }
    results, poses, stats = slam_training_step(mesh, frames, graph)
    if not (torch.isfinite(poses).all() and torch.isfinite(stats.chi2_final)
            and torch.isfinite(results.pose).all()):
        raise RuntimeError("dryrun_multichip: non-finite result of the sharded SLAM step")

    # the scale-out solver of full solves: submap Schur elimination over the
    # mesh on a drifted chain with loop closures, the robust policy active
    Vs = 128
    step_s = se3np.se3_exp(np.array([0, 0, 2 * np.pi / Vs, 1.0, 0, 0]))
    gts = [se3np.pose_identity()]
    for _ in range(Vs - 1):
        gts.append(se3np.pose_compose(gts[-1], step_s))
    eijs, ezs, rob, drifted = [], [], [], [gts[0]]
    for i in range(Vs - 1):
        zn = se3np.pose_retract(se3np.pose_between(gts[i], gts[i + 1]), rng.normal(0, 0.01, 6))
        eijs.append((i, i + 1))
        ezs.append(zn)
        rob.append(False)
        drifted.append(se3np.pose_compose(drifted[-1], zn))
    for a, b in [(0, Vs - 1), (2, Vs // 2)]:
        eijs.append((a, b))
        ezs.append(se3np.pose_between(gts[a], gts[b]))
        rob.append(True)
    E = len(eijs)
    poses_s, stats_s = optimize_pose_graph_schur(
        torch.as_tensor(np.stack(drifted), dtype=torch.float32, device=dev),
        np.asarray(eijs, np.int32), np.float32(np.stack(ezs)), np.full((E, 6), 10.0, np.float32),
        np.ones(E, bool), n_submaps=2 * n_devices, mesh=mesh, edges_robust=np.asarray(rob),
        params=PoseGraphParams(gn_iters=6))
    chi2 = [float(stats_s.chi2_initial), float(stats_s.chi2_final)]
    if not torch.isfinite(poses_s).all() or not chi2[1] < chi2[0]:
        raise RuntimeError(f"dryrun_multichip: Schur solve over the mesh, chi2 {chi2}")
    return {"sharded_chi2": [float(stats.chi2_initial), float(stats.chi2_final)],
            "schur_chi2": chi2}


def main(argv=None):
    ap = argparse.ArgumentParser(description="run the flagship step once, or the "
                                 "multi-device dry run in every rank of the launch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun", action="store_true",
                    help="dryrun_multichip over every rank the launcher started")
    args = ap.parse_args(argv)
    if args.dryrun:
        multihost.initialize_from_env(backend="gloo" if args.device == "cpu" else None)
        rank, world = multihost.process_info()
        chi2 = dryrun_multichip(world, device=args.device)
        if rank == 0:
            print(f"dryrun_multichip OK on {world} rank(s), {args.device}: {chi2}")
        return
    fn, example_args = entry(args.device)
    _, pose, converged = fn(*example_args)
    pose = pose.cpu().numpy()
    if not np.isfinite(pose).all():
        raise SystemExit(f"entry(): non-finite pose {pose}")
    print(f"entry() OK on {args.device}: pose {pose.round(6).tolist()}, "
          f"converged {bool(converged)}")


if __name__ == "__main__":
    main()
