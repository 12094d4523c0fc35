#!/usr/bin/env python3
"""North-star benchmarks of the PyTorch/CUDA port on one card: ``bench.py``'s
metrics through ``lmsf_slam_tpu_torch``.

    python3 bench_torch.py [--device cpu] [--out FILE.json]

Measures, end to end on simulator scans, what ``bench.py`` measures for the
JAX package, with the same constants and the same printed schema:

1. ``frontend_fps_per_chip`` (headline): range-image organization → LOAM
   features → ``tracker_step`` (constant-velocity predict, fused edge/surf
   Gauss-Newton against the local map, map update) at VLP-16 scale (16 × 1800,
   6 sectors × 20 / 40 features, a 20-scan window, 10 GN iterations); 3
   warm-up frames, 30 timed.
2. ``registration_fps``: scan-to-scan ``register_edge_surf`` at VLP-16 and
   HDL-64 (64 × 1800) feature sizes, 20 timed calls each, against the C++
   reference's scan-to-scan mean (55.5 ms).
3. ``posegraph_1905v_ms`` and ``posegraph_1905v_schur_ms``: bench.py's
   1905-vertex helix (``build_posegraph``) through the replicated PCG solve
   and through the submap Schur solve at 2048 / 16 submaps, 60 GN × 128 PCG
   iterations, 5 timed solves each after a warm-up; bench.py's asserts hold
   (chi2 under twice the noise floor, aligned ATE under 1 m for both).
4. ``e2e_system_fps``: ``MultiLidarSystem.process`` at the same widths, the
   backend inline (``sync_fps``) and on its worker thread
   (``async_policy="block"``, ``optimize_window=50``, the queue drained by
   ``flush()`` inside the clock).

Every timed window ends in ``torch.cuda.synchronize()`` or a read-back. The
``vs_baseline`` ratios are against the C++ reference's CPU times, as in
bench.py. Scans are drawn from seeded numpy generators (one a scan), so they
are not bench.py's JAX draws. Runs on the card unless ``--device cpu``; with
no card and no ``--device cpu`` it exits non-zero.

Prints a line with the card's name and power limit (``nvidia-smi``) and each
function's k-NN and projector kernel launches, then the result as ONE JSON
line, last.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_SCAN_MAP_MS = 105.9  # reference scan-to-map mean latency
BASELINE_SCAN_SCAN_MS = 55.5  # reference scan-to-scan mean latency

RINGS, WIDTH = 16, 1800  # VLP-16 @ 10 Hz
SECTORS, EDGES_PS, SURFS_PS = 6, 20, 40  # → 1920 edge / 3840 surf per scan
N_WARM = 3
N_FRAMES = 30
REG_CALLS = 20
REG_SCANS = {"vlp16": (16, 1800, 20, 40), "hdl64": (64, 1800, 20, 40)}
REG_SEEDS = (100, 101)  # the two scans of the registration pair
POSEGRAPH_VERTICES = 1905  # the reference trajectory's length
POSEGRAPH_PADDED = 2048  # vertices and edge slots of the Schur solve
POSEGRAPH_SUBMAPS = 16
POSEGRAPH_SOLVES = 5


def synchronize(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def launches():
    """The port's kernel launch counts since the last reset."""
    from lmsf_slam_tpu_torch import _build

    return {name: _build.launches.get(name, 0) for name in ("knn", "knn_merge", "projector")}


def make_course(n=N_WARM + N_FRAMES):
    """bench.py's world (30 m extent, 14 boxes, 24 cylinders) and its
    n-pose open arc of 9 m radius at 1.4 m; the poses as numpy."""
    from lmsf_slam_tpu_torch.datasets import make_sim_world, make_trajectory

    world = make_sim_world(np.random.default_rng(0), extent=30.0, n_boxes=14, n_cylinders=24)
    traj = make_trajectory(n, radius=9.0, loop=False, device="cpu").numpy().copy()
    traj[:, 6] = 1.4
    return world, traj


def make_scan(world, pose, seed, rings=RINGS, width=WIDTH, device="cuda"):
    """One scan at ``pose`` (60 m range, 1 cm noise), its noise drawn from
    ``default_rng((0, seed))``: bench.py draws scan i from ``fold_in(key, i)``."""
    from lmsf_slam_tpu_torch.datasets import simulate_scan

    return simulate_scan(world, pose, np.random.default_rng((0, seed)), rings=rings, width=width,
                         max_range=60.0, noise=0.01, device=device)


def front_end(scan, rings=RINGS, width=WIDTH, sectors=SECTORS, edges_ps=EDGES_PS,
              surfs_ps=SURFS_PS):
    """Range image and LOAM features of one scan, as bench.py's step makes them."""
    from lmsf_slam_tpu_torch.ops import features as F

    grid = F.organize_scan(scan, rings=rings, width=width)
    return F.extract_loam_features(grid, sectors=sectors, edges_per_sector=edges_ps,
                                   surfs_per_sector=surfs_ps)


def tracker_config(rings=RINGS, sectors=SECTORS, edges_ps=EDGES_PS, surfs_ps=SURFS_PS):
    from lmsf_slam_tpu_torch.ops.registration import RegistrationParams
    from lmsf_slam_tpu_torch.tracker import TrackerConfig

    return TrackerConfig(
        window=20,
        edge_capacity=rings * sectors * edges_ps,
        surf_capacity=rings * sectors * surfs_ps,
        registration=RegistrationParams(max_iters=10),
    )


def make_step(config, rings=RINGS, width=WIDTH, sectors=SECTORS, edges_ps=EDGES_PS,
              surfs_ps=SURFS_PS):
    """bench.py's frame: organize → features → ``tracker_step``; returns
    (state, pose)."""
    from lmsf_slam_tpu_torch.tracker import tracker_step

    def step(state, scan, t):
        feats = front_end(scan, rings, width, sectors, edges_ps, surfs_ps)
        state, out = tracker_step(state, feats.edge, feats.surf, t, config)
        return state, out.pose

    return step


def bench_frontend(world, traj, device="cuda"):
    """Frames a second of the front end; returns (fps, the pose tensors of
    every frame, warm-up included)."""
    import torch

    from lmsf_slam_tpu_torch.tracker import tracker_init

    scans = [make_scan(world, traj[i], i, device=device) for i in range(N_WARM + N_FRAMES)]
    config = tracker_config()
    step = make_step(config)
    state = tracker_init(config, device=device)
    stamps = [torch.tensor(0.1 * i, dtype=torch.float32, device=device)
              for i in range(N_WARM + N_FRAMES)]
    poses = []
    for i in range(N_WARM):  # builds the kernels, fills the map
        state, pose = step(state, scans[i], stamps[i])
        poses.append(pose)
    synchronize(device)
    t0 = time.perf_counter()
    for i in range(N_WARM, N_WARM + N_FRAMES):
        state, pose = step(state, scans[i], stamps[i])
        poses.append(pose)
    synchronize(device)
    return N_FRAMES / (time.perf_counter() - t0), poses


def registration_pair(scan_a, scan_b, rings, width, edges_ps, surfs_ps, sectors=6):
    """Scan b's features registered against scan a's from identity
    (bench.py's ``reg``); returns the pose."""
    from lmsf_slam_tpu_torch.common import se3
    from lmsf_slam_tpu_torch.ops.registration import RegistrationParams, register_edge_surf

    fa = front_end(scan_a, rings, width, sectors, edges_ps, surfs_ps)
    fb = front_end(scan_b, rings, width, sectors, edges_ps, surfs_ps)
    res = register_edge_surf(fb.edge, fb.surf, fa.edge, fa.surf,
                             init_pose=se3.pose_identity(device=scan_a.xyz.device),
                             params=RegistrationParams(max_iters=10))
    return res.pose


def registration_scans(world, traj, device="cuda"):
    """Each width's scan pair, at the course's first two poses."""
    return {name: tuple(make_scan(world, traj[i], seed, rings, width, device)
                        for i, seed in enumerate(REG_SEEDS))
            for name, (rings, width, _, _) in REG_SCANS.items()}


def bench_registration(world, traj, device="cuda"):
    """Standalone registration fps at VLP-16 and HDL-64 feature scales;
    returns ({width: fps}, {width: pose})."""
    pairs = registration_scans(world, traj, device)
    fps, poses = {}, {}
    for name, (rings, width, eps, sps) in REG_SCANS.items():
        a, b = pairs[name]
        pose = registration_pair(a, b, rings, width, eps, sps)
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(REG_CALLS):
            pose = registration_pair(a, b, rings, width, eps, sps)
        synchronize(device)
        fps[name] = REG_CALLS / (time.perf_counter() - t0)
        poses[name] = pose
    return fps, poses


def build_posegraph(V=POSEGRAPH_VERTICES, seed=0, padded_to=POSEGRAPH_PADDED):
    """bench.py's pose graph (``bench_posegraph``) as numpy arrays: a V-vertex
    helix (a climb in z makes the ground truth unique), odometry edges with
    the reference's noise model (σ 0.01 rad / 0.05 m), 96 exact loop edges
    100+ vertices apart, sqrt-information 100 / 20, the robust kernel on the
    loop edges only, the initial guess integrated from the odometry.

    Returns (ground truth (V, 7), the graph as ``optimize_pose_graph`` takes
    it, the graph padded to ``padded_to`` vertices and edge slots with vertex
    0 and the tail fixed, as ``optimize_pose_graph_schur`` takes it)."""
    from lmsf_slam_tpu_torch.common import se3np

    rng = np.random.default_rng(seed)
    step = se3np.se3_exp(np.array([0, 0, 0.04, 1.2, 0, 0.08], np.float32))
    gt = [se3np.pose_identity()]
    for _ in range(V - 1):
        gt.append(se3np.pose_compose(gt[-1], step))
    gt = np.stack(gt).astype(np.float32)
    eij, ez = [], []
    for i in range(V - 1):
        z = se3np.pose_between(gt[i], gt[i + 1])
        pert = np.concatenate([rng.normal(0, 0.01, 3), rng.normal(0, 0.05, 3)])
        eij.append((i, i + 1))
        ez.append(np.float32(se3np.pose_compose(z, se3np.se3_exp(np.float32(pert)))))
    for _ in range(96):  # ~5% loop closures
        i = int(rng.integers(0, V - 200))
        j = int(rng.integers(i + 100, V))
        eij.append((i, j))
        ez.append(np.float32(se3np.pose_between(gt[i], gt[j])))
    eij, ez = np.asarray(eij, np.int32), np.stack(ez).astype(np.float32)
    init = [gt[0]]
    for e in range(V - 1):
        init.append(np.float32(se3np.pose_compose(init[-1], ez[e])))
    init = np.stack(init).astype(np.float32)
    E = eij.shape[0]
    sqrtw = np.tile(np.array([100.0] * 3 + [20.0] * 3, np.float32), (E, 1))
    erob = np.arange(E) >= V - 1
    plain = dict(poses=init, vmask=np.ones(V, bool), edges_ij=eij, edges_z=ez,
                 edges_sqrtw=sqrtw, emask=np.ones(E, bool), edges_robust=erob)
    P = padded_to
    poses = np.zeros((P, 7), np.float32)
    poses[:, 0] = 1.0
    poses[:V] = init
    peij = np.zeros((P, 2), np.int32)
    pez = np.zeros((P, 7), np.float32)
    pez[:, 0] = 1.0
    psw = np.zeros((P, 6), np.float32)
    pem = np.zeros(P, bool)
    per = np.zeros(P, bool)
    peij[:E], pez[:E], psw[:E], pem[:E], per[:E] = eij, ez, sqrtw, True, erob
    fixed = np.zeros(P, bool)
    fixed[0] = True
    fixed[V:] = True
    padded = dict(poses=poses, edges_ij=peij, edges_z=pez, edges_sqrtw=psw, emask=pem,
                  edges_robust=per, fixed=fixed)
    return gt, plain, padded


def posegraph_params():
    from lmsf_slam_tpu_torch.backend.pose_graph import PoseGraphParams

    return PoseGraphParams(gn_iters=60, pcg_iters=128)


def bench_posegraph(device="cuda"):
    """The 1905-vertex robust GN solve, replicated and Schur; returns (ms,
    chi2 before, chi2 after, ATE, GN iterations, Schur ms, Schur ATE)."""
    import torch

    from lmsf_slam_tpu_torch.backend.pose_graph import optimize_pose_graph
    from lmsf_slam_tpu_torch.evaluation import ate_stats
    from lmsf_slam_tpu_torch.parallel import optimize_pose_graph_schur

    V = POSEGRAPH_VERTICES
    params = posegraph_params()
    gt, plain, padded = build_posegraph()
    t = {k: torch.as_tensor(v, device=device) for k, v in plain.items()}

    def timed(solve):
        out, stats = solve()  # warm-up
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(POSEGRAPH_SOLVES):
            out, stats = solve()
        out = out.cpu().numpy()
        return out, stats, (time.perf_counter() - t0) / POSEGRAPH_SOLVES * 1e3

    out, stats, ms = timed(lambda: optimize_pose_graph(**t, params=params))
    ate = float(ate_stats(out, gt).rmse)
    chi2_0, chi2_1 = float(stats.chi2_initial), float(stats.chi2_final)
    iters = int(stats.iterations)
    # noise floor: E[chi2] = 6·(V−1) for whitened unit residuals
    floor = 6 * (V - 1)
    assert chi2_1 < 2 * floor, (chi2_1, floor)
    assert ate < 1.0, ate

    kw = dict(padded)
    poses = torch.as_tensor(kw.pop("poses"), device=device)
    sout, _, schur_ms = timed(lambda: optimize_pose_graph_schur(
        poses, **kw, n_submaps=POSEGRAPH_SUBMAPS, params=params))
    schur_ate = float(ate_stats(sout[:V], gt).rmse)
    assert schur_ate < 1.0, schur_ate
    return ms, chi2_0, chi2_1, ate, iters, schur_ms, schur_ate


def system_config(pipelined: bool):
    """bench.py's system: the front end's widths and GN iterations; with
    ``pipelined`` the backend on its worker thread (lossless ``block``
    policy, windowed re-solves), else inline."""
    from lmsf_slam_tpu_torch.backend import LifelongConfig
    from lmsf_slam_tpu_torch.ops.registration import RegistrationParams
    from lmsf_slam_tpu_torch.system import FeatureParams, SystemConfig

    return SystemConfig(
        feature=FeatureParams(rings=RINGS, width=WIDTH, sectors=SECTORS,
                              edges_per_sector=EDGES_PS, surfs_per_sector=SURFS_PS),
        registration=RegistrationParams(max_iters=10),
        async_backend=pipelined,
        async_policy="block",
        lifelong=LifelongConfig(optimize_window=50) if pipelined else LifelongConfig(),
    )


def bench_system(world, traj, pipelined: bool, device="cuda"):
    """``MultiLidarSystem.process`` frames a second; returns (fps, the
    system, flushed)."""
    from lmsf_slam_tpu_torch.system import MultiLidarSystem

    scans = [make_scan(world, traj[i], i, device=device) for i in range(N_WARM + N_FRAMES)]
    system = MultiLidarSystem(system_config(pipelined), device=device)
    for i in range(N_WARM):
        system.process(scans[i], 0.1 * i)
    system.flush()  # warm-up work drained off the clock
    synchronize(device)
    t0 = time.perf_counter()
    for i in range(N_WARM, N_WARM + N_FRAMES):
        system.process(scans[i], 0.1 * i)  # ends in the frame's read-back
    if pipelined:
        # the rate includes draining the backend queue: every keyframe's
        # backend work must be finished for the rate to be sustainable
        system.flush()
    dt = time.perf_counter() - t0
    system.flush()
    return N_FRAMES / dt, system


def summary(fps, reg, pg, sys_fps, pipe_fps):
    """bench.py's printed result: the headline metric (``metric``, ``value``,
    ``unit``, ``vs_baseline``) with the other metrics under ``extras``. ``pg`` is what
    :func:`bench_posegraph` returns."""
    pg_ms, chi2_0, chi2_1, pg_ate, pg_iters, schur_ms, schur_ate = pg
    baseline_fps = 1000.0 / BASELINE_SCAN_MAP_MS
    return {
        "metric": "frontend_fps_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline_fps, 2),
        "extras": {
            "registration_fps_vlp16": {
                "value": round(reg["vlp16"], 2), "unit": "frames/s",
                "vs_baseline": round(reg["vlp16"] / (1000.0 / BASELINE_SCAN_SCAN_MS), 2),
            },
            "registration_fps_hdl64": {
                "value": round(reg["hdl64"], 2), "unit": "frames/s",
            },
            "posegraph_1905v_ms": {
                "value": round(pg_ms, 1), "unit": "ms",
                "chi2": [round(chi2_0, 1), round(chi2_1, 3)],
                "solve_ate_m": round(pg_ate, 4),
                "gn_iters_used": pg_iters,
            },
            "posegraph_1905v_schur_ms": {
                "value": round(schur_ms, 1), "unit": "ms",
                "solve_ate_m": round(schur_ate, 4),
            },
            "e2e_system_fps": {
                "value": round(pipe_fps, 2), "unit": "frames/s",
                "vs_baseline": round(pipe_fps / baseline_fps, 2),
                "sync_fps": round(sys_fps, 2),
            },
        },
    }


def card_line(device):
    """The card's name and power limit as nvidia-smi gives them."""
    import torch

    if torch.device(device).type != "cuda":
        return "device: cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", help="also write the result and the launch counts to this JSON file")
    args = ap.parse_args(argv)

    import torch

    from lmsf_slam_tpu_torch import _build

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    dev = args.device
    world, traj = make_course()
    counts = {}

    def counted(name, fn, *a):
        _build.reset_launches()
        out = fn(*a)
        counts[name] = launches()
        return out

    fps, _ = counted("frontend", bench_frontend, world, traj, dev)
    reg, _ = counted("registration", bench_registration, world, traj, dev)
    pg = counted("posegraph", bench_posegraph, dev)
    sys_fps, _ = counted("system_sync", bench_system, world, traj, False, dev)
    pipe_fps, system = counted("system_async", bench_system, world, traj, True, dev)
    system._async.close()

    result = summary(fps, reg, pg, sys_fps, pipe_fps)
    card = card_line(dev)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "launches": counts, "result": result}, fh, indent=1)
    print(f"{card}; kernel launches: {json.dumps(counts)}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
