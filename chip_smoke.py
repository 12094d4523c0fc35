#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lmsf_slam_tpu_torch``) on one card.

    python3 chip_smoke.py [--out FILE.json]

Needs one CUDA device; exits non-zero without one, or when any phase fails.
Phases, one line each:

1. build   — compile ``lmsf_slam_tpu_torch/csrc/knn.cu`` and
             ``csrc/projector.cu`` with nvcc for sm_90a (into
             ``build/kernels/``, one nvcc a source, started together) and
             print ptxas' register, shared-memory and spill summary;
2. kernel  — hold the k-NN kernels (``knn_cuda``: the scan over reference
             slices and the merge) against the plain torch version of the
             whole function (``knn_plain``) on the card: at the slice's
             shapes (384×8192 and 1536×16384 at k=5, 1920×24576 at k=1; the
             backend's local maps of 7, 10 and 11 keyframes: 384×2688,
             384×3840, 384×4224, 1536×10752, 1536×15360, 1536×16896; the
             city's ten; the fused two-LiDAR frame's 768×8192) and
             at the corner cases (masked queries, a size that is no multiple
             of slice or tile, duplicated references, Q=1, N=1, no valid
             reference, no valid query, k above the number of valid
             references with several slices). The small cases must also equal
             a single ascending scan ordered by (d, idx) bit for bit, and the
             result must not change with the number of slices or lanes. Then
             time kernels, plain version and ``torch.cdist`` + ``torch.topk``
             (a yardstick the port never calls) with CUDA events, beside the
             bound and the time of an empty launch;
2b. projector — hold the degeneracy projector kernel (``projector_cuda``:
             a screen that proves every eigenvalue of the registration's 6×6
             normal matrix above the floor, else a warp-parallel round-robin
             Jacobi in float64) against its plain version
             (``projector_plain``, through ``torch.linalg.eigh``) on the card:
             at the normal matrices of every association of fused frames 1
             and 2, one a launch as the path launches it, at corner cases
             (non-finite, a corridor with one direction under the floor,
             isotropic, the absolute floor, zero), at a boundary batch
             (diagonal matrices whose smallest eigenvalue lies at, just under
             and just over the float32 rounding midpoint above the floor) and
             over a batch of random normal matrices: equal counts of
             constrained directions, projectors within 1e-9; the kernel's
             screen decisions and sweeps equal to its CPU model's
             (``projector_jacobi_plain``). Then time it on a screened path
             matrix, on the corridor (the Jacobi path) and on the batch beside
             ``torch.linalg.eigh`` alone, the plain version, the bound and an
             empty launch;
3. slice   — 60 frames of a simulated VLP-16 course through
             ``build_fused_step(SystemConfig(), "cuda")`` and the keyframe
             gate at the default widths, one read-back per frame; checks the
             poses are finite, the ATE against ground truth, that every
             association went through the kernels (launch counters: k-NN and
             projector), and that the first 10 frames agree with the same run
             on the CPU;
4. profile — ``torch.profiler`` over 5 frames: device time and device events
             per frame and the kernels that take the time, beside what the
             earlier one-thread-a-query kernel read; one device-to-host copy a
             frame (the frame's read-back);
5. backend — the whole system at full width: 120 frames of a closed circle of
             9 m radius (world of 30 m extent, 14 boxes, 24 cylinders; scans
             16 × 900 to 60 m) through ``MultiLidarSystem(config).process`` on
             ``cuda`` with the lifelong backend behind the keyframe gate
             (keyframe database with its device mirror, scan-context loop
             search, two-stage verification, windowed and full pose-graph
             solves, the MAPPING / LOCALIZATION machine). Checks: finite
             poses, at least one loop closed and MAPPING → LOCALIZATION after
             it, a full solve (and a windowed one past 51 keyframes),
             map-frame ATE under 0.15 m and no worse than odometry alone by
             more than 0.01 m, every k-NN through the kernels, and the first
             10 keyframes' map poses within 1e-3 m of the same course on the
             CPU. Prints frame times with and without keyframe frames, the
             backend's stage timers, k-NN launches a keyframe and the
             mirror's bytes;
6. reboot  — a second backend on the database just built boots in
             RELOCALIZATION; a fresh system around it is fed the course from
             its middle and must relocalize within 10 keyframes and then stay
             within 0.5 m of the ground truth expressed in the map frame.

7. async   — the closed course of phase backend again through
             ``MultiLidarSystem(config._replace(async_backend=True))``: the
             backend on its worker thread, policy ``coalesce``, then
             ``flush()``. Checks: nothing dropped, the same loop edges and
             final mode as the sync run, map-frame ATE under 0.15 m, the
             front end's odometry equal to the sync run's, the keyframe map
             poses after the flush equal to the sync run's, and every frame's
             correction one the sync run had published by that frame (all to
             1e-3; the worker's lag, which the host's speed sets, decides
             which). Prints sync beside async: frame times, keyframe-frame
             times, the lag, the peak backlog, ``coalesced``, stages;
8. city    — this slice's path at full width: the first 500 frames of the
             city course (a street grid of 3 × 2 blocks, 18 buildings and 136
             trunks, 8 moving cars), HDL-64 scans (64 × 1800, 2.5–80 m, noise
             0.01 m) rendered on the card, 1536 edge and 3072 surf features a
             frame, through the lifelong deployment: worker-thread backend,
             insert probation and map carving in the tracker, trimmed
             registration, carving of the 3 nearest stored keyframes, the
             unsupported-point gate, a 1536 × 1536 occupancy grid at 0.25 m,
             windowed solves over 100 keyframes, the loop detector's
             unrelaxed 0.05 score gates, the keyframe payload in memmaps on
             disk, the submap Schur solve from 192 keyframes (500 frames
             store fewer, so every full solve is replicated). Checks: finite poses, a loop closed, a
             windowed solve, LOCALIZATION reached, no keyframe dropped, points
             carved and every carved row's mirror masks equal to the host's,
             a grid with occupied and free cells inside its clip, map-frame
             ATE under 0.5 m and under odometry's, frames after the loop
             closure that carry the worker's correction, and that the card
             repeats: ``voxel_downsample`` and the first 20 frames' odometry
             bit for bit in a second run;
9. persist — ``system.save`` of that run (memmap checkpoint), the system
             dropped, ``MultiLidarSystem.load(path, config, device="cuda")``:
             boots in RELOCALIZATION with the grid rebuilt from the database,
             is fed 100 frames of a street the first session mapped (no
             cars), must relocalize within 10 keyframes and then stay within
             0.5 m of the ground truth in the first session's map frame; the
             checkpoint's files are byte-equal before and after. Also a
             RAM-mode save → load round trip of the same database;
10. merge  — a second session maps 120 frames of a stretch the first also
             drove, in its own map frame; ``align_sessions`` must find at
             least 3 consistent matches and the transform within 0.5 m / 2°
             of the truth; ``merge_sessions`` then a full solve: counts add
             up, inter-session edges are loop edges, finite poses;
11. lio    — the IMU-aided system at full width: the first 300 frames of the
             city course as HDL-64 motion-blurred sweeps (each azimuth
             column cast from its own pose along the frame's motion),
             rendered on the card, with the course's 100 Hz IMU windows
             (seed 7), through ``MultiLidarSystem(config, device="cuda")``
             with ``use_imu`` and the sync backend, the configuration of
             ``scripts/evaluate.py::run_city --imu --sync`` (no movers, no
             probation), the filter
             anchored with the course velocity. Checks: finite poses, map-frame
             ATE under 0.3 m, a loop closed, no failure reset of the filter,
             every association through the k-NN and projector kernels (launch
             counters), no device-to-host copy in the filter's own work and one
             (the frame's read-back) on each profiled frame without a keyframe,
             the first 5 frames within 1e-3 m of the same frames on the CPU; a
             GNSS
             fix after frame 0 of a second, short run rides the next keyframe as
             a prior at the ENU origin; then ``FactorGraphLio`` over 40 of the
             course's IMU windows with the LIO poses as priors, card against
             CPU to 1e-4 m, chi2 falling at every solve. Prints frame times,
             device events and read-backs a frame beside the fused frame's, the
             ESKF propagation's time a frame, the backend's stages and the peak
             device memory;
12. schur  — the submap Schur solve (``parallel/schur.py``): bench.py's
             pose graph (a 1905-vertex helix with 96 loop edges, padded to
             2048 vertices and edges, the tail and vertex 0 fixed) at 16
             submaps: ATE under 1 m (bench.py's assertion), the same solve on
             the CPU at the same chi2 (5e-3) and ATE (1e-3 m), in float64
             card vs CPU poses within 1e-4 m, two card runs bit-equal, ms a
             solve
             (median of 3 after a warm-up) beside the replicated
             ``optimize_pose_graph``; then the merged sessions' database
             (``eval_fused/fused_db.npz``, 411 keyframes) from its solved
             poses moved by a seeded random walk, through
             ``LifelongBackend.optimize(full=True)`` as
             ``scripts/fuse_sessions.py`` configures it: the Schur path
             taken, chi2 back within 10 % of the reference's 1.2976, card vs
             CPU within 5e-4 m, ms beside the replicated ``optimize_full``,
             and at a budget where both converge the Schur solve within
             5e-3 of the replicated one;
13. dual   — two LiDARs (16 × 900 each) through
             ``MultiLidarSystem(n_lidars=2)`` on ``cuda`` over the 40 frames
             of ``tests/test_multilidar.py``'s scenario (its world's sizes,
             wavy trajectory, 30° / (0, −0.6, 0.3) m extrinsic, calibration
             gates), the extrinsic unknown: phase 2 reached in order, the
             extrinsic within 0.05 m / 2°, ATE under 0.3 m, every phase
             through the k-NN and projector kernels, the fused frame's k-NN
             shape met, the first 5 frames within 1e-3 m of the CPU; then 12
             frames with the extrinsic given (fused from frame 0). Prints
             frame times, launches a frame and, from ``torch.profiler``,
             copies and host waits a frame for each calibration phase and
             for fused frames.

After each phase a line says how many of its projector matrices took the
Jacobi path (``JacobiTally``: the kernel's sweeps, kept on the card and read
once at the phase's end). Temporary files go under ``build/chip_smoke_tmp``
and are removed. Then a line with each phase's wall time, the card's name
and power limit, one JSON line of kernel numbers, and the result line
``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# The H100 SXM's published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores and HBM3 bandwidth. Used for the bound only.
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12  # FP64 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

N_FRAMES = 60
N_CPU_FRAMES = 10
ATE_LIMIT = 0.15  # m, the reference system test's threshold
CPU_AGREE = 1e-3  # m / quaternion component, card vs CPU over the first frames
KNN_PER_FRAME = 10  # 5 associations × (edge + surf) at the default cadence
PROJECTOR_PER_FRAME = 5  # one degeneracy projector an association
PROJECTOR_AGREE = 1e-9  # projector entries, kernel vs torch.linalg.eigh (both float64)
PROJECTOR_BATCH = 4096  # random normal matrices compared in one launch
# the boundary batch: one launch a floor and an offset of the smallest
# eigenvalue from the float32 rounding midpoint above the floor
PROJECTOR_FLOORS = ("relative", "absolute", "no matches")
PROJECTOR_OFFSETS = ("at", "under", "over")
PROJECTOR_BOUNDARY = [f"{f} floor, {o} the midpoint" for f in PROJECTOR_FLOORS
                      for o in PROJECTOR_OFFSETS]
# which of the batch's five matrices the screen passes: the two with an
# eigenvalue at the midpoint no, the two clear of it yes, the non-finite no
PROJECTOR_BOUNDARY_SCREENED = (False, False, True, True, False)

# What the profile phase read on the earlier one-thread-a-query kernel, whose
# wrapper rescored and sorted with torch ops (NVIDIA H100 80GB HBM3, 700 W),
# printed beside this run's numbers.
EARLIER_KNN_MS_PER_FRAME = 4.78
EARLIER_EVENTS_PER_FRAME = 6722
# and on the earlier projector kernel, one thread a matrix and cyclic Jacobi
# (the same card)
EARLIER_PROJECTOR_MS_PER_FRAME = 0.1316


# phase backend: the looped course and its limits
LOOP_FRAMES = 120
LOOP_SEED = 0
N_CPU_KEYFRAMES = 10  # keyframes compared with the same course on the CPU
ODOM_ATE_SLACK = 0.01  # m, map-frame ATE may exceed odometry's by this much
REBOOT_START = 40  # the second run starts at this frame of the course
REBOOT_FRAMES = 45
REBOOT_KEYFRAMES = 10  # it must relocalize within this many keyframes
REBOOT_LIMIT = 0.5  # m from the ground truth in the map frame, once localized

# shapes the backend gives the k-NN: (edge 384 | surf 1536) × local maps of 7
# (loop verification at adjacent_window=3), 10 (localization_knn) and 11
# (adjacent_window=5) keyframes
BACKEND_SHAPES = [
    ("loop7 edge 384x2688 k=5", 384, 2688), ("loop7 surf 1536x10752 k=5", 1536, 10752),
    ("loc10 edge 384x3840 k=5", 384, 3840), ("loc10 surf 1536x15360 k=5", 1536, 15360),
    ("loop11 edge 384x4224 k=5", 384, 4224), ("loop11 surf 1536x16896 k=5", 1536, 16896),
]


# the city course's k-NN shapes: 1536 edge and 3072 surf features a frame
# against the tracker's registration maps (8192 / 16384), the probation gate's
# nn1 (4608 new points against the 24576-point map and the 4608-point
# probation set), localization on 10 keyframes, loop verification and
# relocalization on 9 (adjacent_window=4), and the unsupported-point gate
# against the 10 keyframes' edge and surf maps together (46080 points)
CITY_SHAPES = [
    ("city frame edge 1536x8192 k=5", 1536, 8192, 5),
    ("city frame surf 3072x16384 k=5", 3072, 16384, 5),
    ("city probation nn1 4608x24576 k=1", 4608, 24576, 1),
    ("city probation nn1 4608x4608 k=1", 4608, 4608, 1),
    ("city loc10 edge 1536x15360 k=5", 1536, 15360, 5),
    ("city loc10 surf 3072x30720 k=5", 3072, 30720, 5),
    ("city loop9 edge 1536x13824 k=5", 1536, 13824, 5),
    ("city loop9 surf 3072x27648 k=5", 3072, 27648, 5),
    ("city unsupported edge 1536x46080 k=1", 1536, 46080, 1),
    ("city unsupported surf 3072x46080 k=1", 3072, 46080, 1),
]
# phase dual: the fused two-LiDAR frame (2 × 384 edge features against the
# edge map; its surf shape, 3072x16384, is the city frame's above)
DUAL_SHAPES = [
    ("dual frame edge 768x8192 k=5", 768, 8192, 5),
]

# phases async, city, persist and merge
CITY_SEED = 0
# 500 frames: the graph passes optimize_window + 1 = 101 keyframes (one every
# third frame) near frame 410, so that a windowed solve runs; the block's
# perimeter closes its loop near frame 250
CITY_FRAMES = 500
CITY_ATE_LIMIT = 0.5  # m
CITY_CORRECTION_M = 0.05  # a frame whose map pose is this far from its odometry pose is corrected
CITY_REPEAT_FRAMES = 20  # the first frames, run twice: the odometry must repeat bit for bit
CITY_KNN_PER_FRAME = 10  # 4 associations × (edge + surf) + the probation gate's two nn1
CITY_REBOOT_START = 60  # the rebooted session drives frames 60..159 of the course
CITY_REBOOT_FRAMES = 100
MERGE_START = 20  # the second session maps frames 20..139
MERGE_FRAMES = 120
MERGE_LIMIT_M = 0.5
MERGE_LIMIT_DEG = 2.0
TMP = os.path.join(ROOT, "build", "chip_smoke_tmp")
# phase lio: the first frames of the city course through the IMU-aided system
LIO_FRAMES = 300
LIO_ATE_LIMIT = 0.3  # m, twice the reference's 0.145 m over the same 300 frames
LIO_CPU_FRAMES = 5  # frames compared with the same run on the CPU
LIO_KNN_PER_FRAME = 8  # 4 associations × (edge + surf); no probation under IMU
LIO_PROFILE_FRAMES = range(100, 106)  # frames profiled one by one (not timed)
LIO_GNSS_LLA = (48.0, 11.0, 500.0)  # the fix that anchors the ENU frame
LIO_GRAPH_WINDOWS = 40  # IMU windows through FactorGraphLio
LIO_GRAPH_AGREE = 1e-4  # m, card vs CPU
SCHUR_VERTICES = 1905  # bench.py's helix: the reference trajectory's length
SCHUR_PADDED = 2048  # vertices and edges, padded as bench.py pads them
SCHUR_SUBMAPS = 16  # config/default.yaml's schur_submaps
SCHUR_ATE_LIMIT = 1.0  # m, bench.py's own assertion on the solve
# m, card vs CPU poses of the merged sessions' solve: 12 float32 GN steps at
# ~100 m (ulp 7.6e-6 m) through cuSOLVER on one side and LAPACK on the other
# (measured 1.34e-4 m on an H100 80GB HBM3 at 700 W; the city graph's CPU
# test against the reference allows the same 5e-4)
SCHUR_AGREE = 5e-4
# bench.py's graph is flat along its bending modes at float32 resolution: card
# and CPU reach the same chi2 and ATE by different paths, with poses up to
# 0.51 m apart, so in float32 they are held by chi2 and ATE (as
# tests/test_schur.py::test_schur_10k_vertices_mesh holds a long chain)
SCHUR_BENCH_CHI2_RTOL = 5e-3
SCHUR_BENCH_ATE_AGREE = 1e-3  # m
# m, card vs CPU poses of the same solve of bench.py's graph in float64, where
# rounding no longer moves the solve along those modes; over its first 12 GN
# iterations, which keeps the CPU's float64 solve short
SCHUR_F64_AGREE = 1e-4
SCHUR_F64_ITERS = 12
SCHUR_REPEATS = 3  # timed solves after a warm-up (median)
FUSED_DB = os.path.join(ROOT, "eval_fused", "fused_db.npz")  # 411 keyframes, 440 edges
FUSED_CHI2 = 1.2976291179656982  # eval_fused/result.json: chi2 after the reference's solve
FUSED_CHI2_SLACK = 0.10  # the solve must bring chi2 back within 10 % of it
FUSED_MIN_VERTICES = 192  # scripts/fuse_sessions.py's schur_min_vertices
FUSED_WALK = (0.01, 0.05)  # rad, m: σ of the random walk that perturbs the solved poses
SCHUR_VS_REPLICATED = 5e-3  # tests/test_schur.py::test_backend_schur_path_matches_replicated
# the budget at which the replicated PCG solve reaches the optimum of the merged
# sessions' graph from the random walk (at the default 12 × 64 it stops ~0.9 m
# short with chi2 1.64 where the Schur solve reads 1.298)
TIGHT = dict(gn_iters=30, pcg_iters=512, converged_dx=1e-7)
DUAL_FRAMES = 40  # tests/test_multilidar.py's course
DUAL_KNOWN_FRAMES = 12  # the second run, with the extrinsic given
DUAL_CPU_FRAMES = 5
DUAL_EXTRINSIC_LIMIT = (0.05, 2.0)  # m, degrees: tests/test_multilidar.py's bounds
DUAL_ATE_LIMIT = 0.3  # m, the same test's bound
DUAL_PROFILE = 2  # frames profiled in each calibration phase and fused (not timed)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters, queued=True):
    """Mean milliseconds of ``fn`` on the card (CUDA events, after warm-up).

    With ``queued`` the launches are enqueued behind a spinning kernel, so the
    host runs ahead and the events bracket back-to-back device work: the time
    is the device's, not the pace at which Python enqueues launches. Without it
    the time is whichever of the two is slower, as a caller in a loop sees it.
    """
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(30_000_000)  # ~17 ms at 1.75 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: the k-NN kernels against their plain versions
# ---------------------------------------------------------------------------


def knn_case(Q, N, q_invalid, r_valid, seed, dev, dup=False):
    """Inputs from a seed. ``r_valid`` is a fraction of valid references, or
    an integer count of them. With ``dup`` every reference point is present
    four times, spread over the whole index range."""
    import torch

    g = np.random.default_rng(seed)
    q = g.standard_normal((Q, 3)) * 15.0
    r = g.standard_normal((N, 3)) * 15.0
    if dup:
        r = np.concatenate([r[: N // 4]] * 4)[g.permutation(4 * (N // 4))]
    if isinstance(r_valid, int):
        rm = np.zeros(r.shape[0], dtype=bool)
        rm[g.choice(r.shape[0], r_valid, replace=False)] = True
    else:
        rm = g.random(r.shape[0]) < r_valid
    q = torch.as_tensor(q, dtype=torch.float32, device=dev)
    r = torch.as_tensor(r, dtype=torch.float32, device=dev)
    qm = torch.arange(Q, device=dev) >= q_invalid
    return q, qm, r, torch.as_tensor(rm, device=dev)


def compare_knn(K, q, qm, r, rm, k, exact_model=False, dup=False, **kernel_args):
    """The whole function on the card: ``knn_cuda`` (the kernels) against
    ``knn_plain`` on the same inputs. Returns (max |Δd| over agreeing rows,
    near-tie rows).

    Distances must agree to rtol 1e-6: the kernel sums (dx² + dy²) + dz² with
    every product and sum rounded, the plain version through ``torch.sum``,
    so they may differ by the summation order of three terms (2–3 float32
    ulps). Indices must agree wherever a distance differs from its neighbours
    by more than 1e-6 relative. The plain version picks its candidates by the
    expansion |q|²+|p|²−2q·p, whose float32 rounding is up to
    ~8·2⁻²³·(|q|²+max|p|²); a row may differ only where the kernel's exact
    distances are no worse than the plain version's by more than that bound (a
    near-tie the expansion cannot resolve). Empty slots and masked queries
    must hold INF and index 0. With ``dup`` (references present several
    times) the plain version's ``topk`` may keep any copy of the point at the
    cut, so the neighbours' coordinates are compared there and the indices
    are left to the model below.

    With ``exact_model`` the kernels must also equal
    ``knn_split_merge_plain(splits=1, lanes=1)`` — one ascending scan ordered
    by (d, idx), with the kernel's own rounding — bit for bit, ties included.
    """
    import torch

    d_k, i_k, _ = K.knn_cuda(q, qm, r, rm, k, **kernel_args)
    d_r, i_r = K.knn_plain(q, qm, r, rm, k)
    torch.cuda.synchronize()
    check(d_k.shape == d_r.shape and i_k.dtype == torch.int32, "knn output shape or type")
    empty = d_k >= 1e30
    check(bool((i_k[empty] == 0).all()) and bool((d_k[empty] == K.INF).all()),
          "an empty slot does not hold INF and index 0")
    check(bool(empty[~qm].all()), "a masked query has a neighbour")
    close = torch.abs(d_k - d_r) <= 1e-6 * torch.abs(d_r)
    row_ok = close.all(dim=1)
    pmax = torch.max(torch.where(rm, torch.sum(r * r, dim=1), 0.0))
    tie_tol = 8.0 * 2.0**-23 * (torch.sum(q * q, dim=1) + pmax)
    tie_row = ~row_ok & (d_k <= d_r + tie_tol[:, None]).all(dim=1)
    n_bad = int((~row_ok & ~tie_row).sum())
    check(n_bad == 0, f"knn kernel disagrees with knn_plain on {n_bad} rows")
    n_tie = int(tie_row.sum())
    check(n_tie <= max(2, q.shape[0] // 100), f"too many near-tie rows: {n_tie}")
    big = torch.full_like(d_r[:, :1], float("inf"))
    gap_prev = torch.cat([big, d_r[:, 1:] - d_r[:, :-1]], dim=1)
    gap_next = torch.cat([d_r[:, 1:] - d_r[:, :-1], big], dim=1)
    rel = 1e-6 * torch.clamp(torch.abs(d_r), min=1e-30)
    distinct = (gap_prev > rel) & (gap_next > rel) & (d_r < 1e30) & row_ok[:, None]
    if dup:
        check(bool(torch.equal(r[i_k.long()][distinct], r[i_r.long()][distinct])),
              "knn neighbours disagree")
    else:
        check(bool(torch.equal(i_k[distinct], i_r[distinct])), "knn indices disagree")
    if exact_model:
        d_m, i_m = K.knn_split_merge_plain(q, qm, r, rm, k, splits=1, lanes=1)
        check(torch.equal(d_k, d_m) and torch.equal(i_k, i_m),
              "knn kernel differs from the single-scan model (ties or rounding)")
    finite = (d_r < 1e30) & row_ok[:, None]
    err = float(torch.max(torch.where(finite, torch.abs(d_k - d_r), 0.0))) if finite.any() else 0.0
    return err, n_tie


def knn_bound_ms(Q, n_valid, N, k):
    """Least time on the card: the larger of the FP32 work the inputs need
    (Q × valid refs × 8 operations: 3 sub, 3 mul, 2 add) and the bytes
    (queries, references and both masks read once, the (Q,k) distances and
    indices written once)."""
    ops = 8.0 * Q * n_valid
    nbytes = Q * 12 + Q + N * 12 + N + Q * k * 8
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def merge_bound_ms(Q, S, k):
    """Least time of the merge alone: the (Q,S,k) partial lists and the query
    mask read once, the (Q,k) outputs written once, against one comparison
    for each partial entry."""
    nbytes = Q * S * k * 8 + Q + Q * k * 8
    t_ops = Q * S * k / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def threads_check(K, rounds=200):
    """The kernels launched from two threads at once, as the frontend and the
    backend's worker launch them (each thread takes the current stream and
    its scratch from the allocator on its own): every result must equal, bit
    for bit, the one the same inputs gave on one thread. Returns the number
    of launches compared."""
    import threading

    import torch

    dev = torch.device("cuda")
    jobs = []
    for seed, (Q, N, k) in enumerate(((1536, 8192, 5), (3072, 46080, 1))):
        q, qm, r, rm = knn_case(Q, N, 3, 0.7, seed=100 + seed, dev=dev)
        jobs.append((q, qm, r, rm, k, K.knn_cuda(q, qm, r, rm, k, neighbors=True)))
    torch.cuda.synchronize()
    failures = []

    def worker(job):
        q, qm, r, rm, k, want = job
        try:
            with torch.cuda.device(dev):
                for _ in range(rounds):
                    got = K.knn_cuda(q, qm, r, rm, k, neighbors=True)
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        failures.append(f"{tuple(q.shape)}x{tuple(r.shape)} k={k} differs")
                        return
        except Exception as exc:  # noqa: BLE001 - reported by the caller's check
            failures.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(job,)) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    torch.cuda.synchronize()
    check(not any(t.is_alive() for t in threads), "a launching thread did not finish")
    check(not failures, f"kernels launched from two threads at once: {failures}")
    return rounds * len(jobs)


def phase_kernel(K):
    import torch

    dev = torch.device("cuda")
    tq = K.THREADS // K.LANES
    log("kernel", f"design: {K.THREADS} threads a block, {K.LANES} lanes a query "
        f"({tq} queries a block), tiles of {K.TILE} references, merge with "
        f"{K.MERGE_LANES} lanes a query; slices of at most {K.MAX_SLICE}, at least "
        f"{K.MIN_SLICE}, grid of at least {K.TARGET_BLOCKS} blocks")
    empty_ms = cuda_ms(K.empty_launch_cuda, 200)
    empty_call_ms = cuda_ms(K.empty_launch_cuda, 200, queued=False)
    log("kernel", f"empty kernel launch: {empty_ms:.5f} ms back to back on the device, "
        f"{empty_call_ms:.5f} ms a call at Python's pace (the practical floor "
        "beside the arithmetic bound)")

    cases = [
        # name, Q, N, k, invalid queries, valid refs (fraction or count), dup, forced S
        ("edge 384x8192 k=5", 384, 8192, 5, 0, 0.7, False, None),
        ("surf 1536x16384 k=5", 1536, 16384, 5, 0, 0.7, False, None),
        ("nn1 1920x24576 k=1", 1920, 24576, 1, 0, 0.7, False, None),
        ("masked 77x333 k=5", 77, 333, 5, 7, 0.9, False, None),
        ("k>valid 40x300 k=8", 40, 300, 8, 5, 5, False, None),
        ("ties 300x4096 k=8 S=5", 300, 4096, 8, 3, 0.8, True, 5),
        ("Q=1 1x5000 k=5", 1, 5000, 5, 0, 0.8, False, None),
        ("N=1 50x1 k=1", 50, 1, 1, 2, 1.0, False, None),
        ("ragged 200x5000 k=5 S=3", 200, 5000, 5, 0, 0.8, False, 3),
        ("no valid ref 64x1000 k=5 S=2", 64, 1000, 5, 0, 0, False, 2),
        ("no valid query 64x1000 k=5 S=2", 64, 1000, 5, 64, 0.8, False, 2),
        ("k>valid 40x3000 k=8 S=6", 40, 3000, 8, 5, 5, False, 6),
    ] + [(name, Q, N, 5, 0, 0.7, False, None) for name, Q, N in BACKEND_SHAPES] + [
        (name, Q, N, k, 0, 0.7, False, None) for name, Q, N, k in CITY_SHAPES + DUAL_SHAPES]
    results = {}
    timed = {}
    for i, (name, Q, N, k, qi, valid, dup, forced) in enumerate(cases):
        q, qm, r, rm = knn_case(Q, N, qi, valid, seed=i, dev=dev, dup=dup)
        S = forced if forced is not None else K.choose_splits(Q, N)
        slice_len = K.slice_length(N, S)
        blocks = -(-Q // tq) * S
        small = N <= 5000
        err, n_tie = compare_knn(K, q, qm, r, rm, k, exact_model=small, dup=dup, splits=S)
        row = {"Q": Q, "N": N, "k": k, "n_valid": int(rm.sum()), "splits": S,
               "slice_len": slice_len, "blocks": blocks, "max_abs_err": err,
               "near_tie_rows": n_tie, "equals_single_scan_model": small}
        results[name] = row
        if name.startswith(("edge", "surf", "nn1", "loop", "loc", "city", "dual")):
            timed[name] = (q, qm, r, rm, k)
            continue
        log("kernel", f"{name}: S={S} (slices of {slice_len}), {blocks} blocks; agrees with "
            f"knn_plain, max |Δd| {err:.3g}, near-tie rows {n_tie}"
            + ("; equal to the single-scan model, indices included" if small else ""))

    for name in ("edge 384x8192 k=5", "surf 1536x16384 k=5"):
        check(results[name]["blocks"] >= 264,
              f"{name}: grid of {results[name]['blocks']} blocks, fewer than 264")
    # choose_splits gives a sane grid at the backend's and the city's shapes
    for name in [c[0] for c in BACKEND_SHAPES + CITY_SHAPES + DUAL_SHAPES]:
        row = results[name]
        check(K.MIN_SLICE <= row["slice_len"] <= K.MAX_SLICE and row["slice_len"] % K.ALIGN == 0
              and row["splits"] > 1,
              f"{name}: S={row['splits']}, slices of {row['slice_len']} points")

    # the result does not depend on the split: other S and L, the same bits
    q, qm, r, rm, k = timed["surf 1536x16384 k=5"]
    d0, i0, nbr0 = K.knn_cuda(q, qm, r, rm, k, neighbors=True)
    for splits, lanes in ((3, 4), (1, 8), (16, 4)):
        d1, i1, _ = K.knn_cuda(q, qm, r, rm, k, splits=splits, lanes=lanes)
        check(torch.equal(d0, d1) and torch.equal(i0, i1),
              f"knn result changes with S={splits}, L={lanes}")
    check(torch.equal(nbr0, r[i0.long()]), "the kernel's neighbour coordinates are not ref[idx]")
    log("kernel", f"surf: S={results['surf 1536x16384 k=5']['splits']}, L={K.LANES} gives the "
        "same distances and indices, bit for bit, as S=3 L=4, S=1 L=8 and S=16 L=4; the "
        "neighbour coordinates equal ref[idx]")

    for name, (q, qm, r, rm, k) in timed.items():
        row = results[name]
        Q, N, S = row["Q"], row["N"], row["splits"]

        def kern():
            return K.knn(q, qm, r, rm, k)

        def kern_nbr():
            return K.knn_with_neighbors(q, qm, r, rm, k)

        def plain():
            return K.knn_plain(q, qm, r, rm, k)

        def lib():
            d = torch.cdist(q, r).masked_fill(~rm[None, :], float("inf"))
            return torch.topk(d, k, dim=1, largest=False)

        # in turns (plain, kernel, library, kernel, plain) on one card
        p1, k1, l1, k2, p2 = (cuda_ms(f, 50) for f in (plain, kern, lib, kern, plain))
        bound, by = knn_bound_ms(Q, row["n_valid"], N, k)
        row.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=l1,
                   bound_ms=bound, bound_by=by, call_ms=cuda_ms(kern, 50, queued=False),
                   with_neighbors_ms=cuda_ms(kern_nbr, 50), empty_launch_ms=empty_ms)
        log("kernel", f"{name}: S={S} (slices of {row['slice_len']}), L={K.LANES}, "
            f"{row['blocks']} blocks; kernels {row['ms']:.4f} ms (with neighbour "
            f"coordinates {row['with_neighbors_ms']:.4f} ms; {row['call_ms']:.4f} ms a call "
            f"at Python's pace), plain {row['plain_ms']:.4f} ms, cdist+topk {l1:.4f} ms, "
            f"bound {bound:.6f} ms ({by}), empty launch {empty_ms:.5f} ms; "
            f"max |Δd| {row['max_abs_err']:.3g}, near-tie rows {row['near_tie_rows']}")

    n_threaded = threads_check(K)
    log("kernel", f"two threads launching at once ({n_threaded} launches of 1536x8192 k=5 and "
        "3072x46080 k=1 with neighbour coordinates): every result equal, bit for bit, to the "
        "one-thread result")

    # the merge kernel alone, at the surf shape, against its plain version
    q, qm, r, rm, k = timed["surf 1536x16384 k=5"]
    S = results["surf 1536x16384 k=5"]["splits"]
    part_d, part_i = K.knn_partial_cuda(q, qm, r, rm, k, S)
    out = (torch.empty((q.shape[0], k), dtype=torch.float32, device=dev),
           torch.empty((q.shape[0], k), dtype=torch.int32, device=dev), None)
    K.knn_merge_cuda(part_d, part_i, qm, r, out)
    d_m, i_m = K.merge_partials_plain(part_d, part_i, qm, k)
    torch.cuda.synchronize()
    check(torch.equal(out[0], d_m) and torch.equal(out[1], i_m.to(torch.int32)),
          "knn merge kernel differs from merge_partials_plain")

    def merge():
        return K.knn_merge_cuda(part_d, part_i, qm, r, out)

    def merge_plain():
        return K.merge_partials_plain(part_d, part_i, qm, k)

    mp1, m1, m2, mp2 = (cuda_ms(f, 50) for f in (merge_plain, merge, merge, merge_plain))
    bound, by = merge_bound_ms(q.shape[0], S, k)
    results["merge at surf"] = {
        "Q": q.shape[0], "splits": S, "k": k, "max_abs_err": 0.0, "ms": (m1 + m2) / 2,
        "plain_ms": (mp1 + mp2) / 2, "bound_ms": bound, "bound_by": by, "library_ms": None}
    log("kernel", f"merge alone, {q.shape[0]}x{S}x{k}: equal to merge_partials_plain; kernel "
        f"{(m1 + m2) / 2:.4f} ms, plain {(mp1 + mp2) / 2:.4f} ms, bound {bound:.6f} ms ({by})")
    return results


# ---------------------------------------------------------------------------
# phase 2b: the degeneracy projector kernel against its plain version
# ---------------------------------------------------------------------------


# FP64 operations the function needs for one matrix: proving every
# eigenvalue above the floor (‖A‖∞: 36 additions and 6 maxima, the margin: 4,
# the LDLᵀ of a 6x6 matrix: 97), or else a 6x6 symmetric eigendecomposition
# (9n³, Golub & Van Loan §8.3) and the projector from it (432)
PROJECTOR_SCREEN_OPS = 143
PROJECTOR_EIGH_OPS = 9 * 6 ** 3 + 432


def projector_bound_ms(B, screened):
    """Least time on the card: the larger of the FP64 work the function
    needs on these inputs (the proof for the ``screened`` matrices, an
    eigendecomposition and P for the others; not the algorithm's sweeps) and
    the bytes (H and the match count read once, P and the count written
    once)."""
    ops = PROJECTOR_SCREEN_OPS * screened + PROJECTOR_EIGH_OPS * (B - screened)
    nbytes = B * (36 * 4 + 4 + 36 * 8 + 4)
    t_ops = ops / PEAK_FP64_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def projector_boundary_cases(device):
    """The boundary batch: {name: (H (5, 6, 6) float32, nmatch (5,) int32 or
    None, params)}, one launch for each floor (relative: 0.01 · 777 matches,
    whose float32 has an odd last bit, so a tie rounds up; absolute: 100,
    even, a tie rounds down; no matches: 0) and each place of the smallest
    eigenvalue: at the float64 midpoint between the floor and the next float32
    above it, 2^-21 of a float32 step under it, or over it. The matrices are
    diagonal, so their eigenvalues are exact: h + damping with h the floor
    itself and a dyadic damping of half a step (± 2^-21 of a step). Of the
    five matrices, 0 has the other eigenvalues at 1000 + 4·floor, 1 one of
    them at 1e30 (where the screen's margin is large), 2 all of them clear of
    the floor, 3 clear with a norm of 1e12, 4 is 2 with an infinite entry."""
    import torch

    from lmsf_slam_tpu_torch.ops.registration import RegistrationParams

    base = RegistrationParams()
    cases = {}
    for floor in PROJECTOR_FLOORS:
        n = {"relative": 777, "absolute": None, "no matches": 0}[floor]
        t = np.float32(base.degen_thresh) if n is None else (
            np.float32(base.degen_rel) * np.float32(n))
        step = float(np.nextafter(t, np.float32(np.inf))) - float(t)
        high = 1000.0 + 4.0 * float(t)
        diags = [[t] + [high + k for k in range(5)],
                 [t] + [high + k for k in range(4)] + [1e30],
                 [high + k for k in range(6)],
                 [high + k for k in range(5)] + [1e12],
                 [high + k for k in range(6)]]
        H = torch.diag_embed(torch.tensor(np.asarray(diags, dtype=np.float32), device=device))
        H[4, 0, 3] = float("inf")
        nm = None if n is None else torch.full((5,), n, dtype=torch.int32, device=device)
        for offset, sign in zip(PROJECTOR_OFFSETS, (0, -1, 1)):
            damping = step / 2 + sign * step * 2.0 ** -21
            cases[f"{floor} floor, {offset} the midpoint"] = (H, nm, base._replace(damping=damping))
    return cases


def projector_exact_count(H, nmatch, params):
    """Directions above the floor of a diagonal H, from its exact eigenvalues
    h_ii + damping; 0 where H is not finite."""
    import torch

    lam = torch.diagonal(H, dim1=-2, dim2=-1).to(torch.float64) + params.damping
    floor = (torch.full(lam.shape[:-1], params.degen_thresh, dtype=torch.float32, device=H.device)
             if nmatch is None else params.degen_rel * nmatch.to(torch.float32))
    finite = torch.all(torch.isfinite(H), dim=(-2, -1))
    ok = (lam.to(torch.float32) > floor[..., None]) & finite[..., None]
    return torch.sum(ok, dim=-1, dtype=torch.int32)


def capture_normal_matrices(scans, frames=2):
    """The registration's (H, match count) at every association of fused
    frames 1.. on the card: the inputs the main path gives the projector
    (frame 0 registers against an empty map, H = 0)."""
    import torch

    from lmsf_slam_tpu_torch.ops import projector as PJ
    from lmsf_slam_tpu_torch.system import SystemConfig, build_fused_step
    from lmsf_slam_tpu_torch.tracker import tracker_init

    cfg = SystemConfig()
    tc, step = build_fused_step(cfg, "cuda")
    captured, real = [], PJ.degeneracy_projector

    def recording(H, nmatch, *args):
        captured.append((H.detach().to(torch.float32).clone(), nmatch.detach().clone()))
        return real(H, nmatch, *args)

    PJ.degeneracy_projector = recording
    try:
        run_frames(step, tracker_init(tc, "cuda"), scans, (cfg.keyframe_trans, cfg.keyframe_rot,
                                                         cfg.keyframe_dt), frames + 1)
    finally:
        PJ.degeneracy_projector = real
    torch.cuda.synchronize()
    return captured[PROJECTOR_PER_FRAME:], cfg.registration


def compare_projector(PJ, H, nmatch, params, plain_on_cpu=False):
    """Kernel against ``projector_plain`` (``torch.linalg.eigh``) on the card:
    the same count of directions above the floor everywhere, NaN where H is
    not finite, and the projectors within PROJECTOR_AGREE (float64 Jacobi and
    cuSOLVER's decomposition agree to a few 1e-15 relative to the largest
    eigenvalue; a projector's entries are O(1)); P = I exactly where the
    screen passed. Then against its CPU model (``projector_jacobi_plain``),
    which repeats its arithmetic operation for operation: the same screen
    decisions and sweeps. Returns (max |ΔP|, sweeps, screened), the last two
    flat on the CPU. ``plain_on_cpu`` runs the plain version on the CPU
    (LAPACK), for inputs whose eigenvalues sit on a float32 rounding tie,
    where cuSOLVER's last bit decides the count."""
    import torch

    args = (params.damping, params.degen_rel, params.degen_thresh)
    P_k, n_k, sw = PJ.projector_cuda(H, nmatch, *args, sweeps=True)
    if plain_on_cpu:
        P_r, n_r = (x.to(H.device) for x in PJ.projector_plain(
            H.cpu(), None if nmatch is None else nmatch.cpu(), *args))
    else:
        P_r, n_r = PJ.projector_plain(H, nmatch, *args)
    torch.cuda.synchronize()
    check(P_k.dtype == torch.float64 and P_k.shape == P_r.shape, "projector output shape or type")
    check(torch.equal(n_k, n_r), f"projector counts differ: kernel {n_k.flatten()[:8].tolist()}, "
          f"plain {n_r.flatten()[:8].tolist()}")
    nan_r = torch.isnan(P_r)
    check(torch.equal(torch.isnan(P_k), nan_r), "projector NaNs differ from the plain version's")
    err = float(torch.max(torch.where(nan_r, 0.0, torch.abs(P_k - P_r))))
    check(err <= PROJECTOR_AGREE, f"projector differs from the plain version by {err:.3g} "
          f"(limit {PROJECTOR_AGREE})")
    Hc = H.cpu().reshape(-1, 6, 6)
    nc = None if nmatch is None else nmatch.cpu().reshape(-1)
    _, n_m, sw_m = PJ.projector_jacobi_plain(Hc, nc, *args)
    screened = PJ.projector_screen_plain(Hc, nc, *args)
    sw = sw.cpu().reshape(-1)
    check(torch.equal(n_k.cpu().reshape(-1), n_m), "projector counts differ from the CPU model's")
    check(torch.equal(sw, sw_m), f"projector sweeps differ from the CPU model's: kernel "
          f"{sw[:8].tolist()}, model {sw_m[:8].tolist()}")
    eye = torch.eye(6, dtype=torch.float64)
    check(bool(torch.all(P_k.cpu().reshape(-1, 6, 6)[screened] == eye)),
          "a screened matrix's projector is not the identity")
    return err, sw, screened


class JacobiTally:
    """Which of a phase's projector matrices took the Jacobi path. While
    installed, ``degeneracy_projector`` asks the kernel for its sweeps on
    CUDA tensors and keeps them on the card; :meth:`counts` reads them once,
    at the end of the phase. It adds no launch and no read-back to the
    frames. A matrix the screen declined that is diagonal already takes 0
    sweeps and is counted with the screened ones."""

    def __init__(self):
        from lmsf_slam_tpu_torch.ops import projector as PJ

        self.PJ, self.real, self.sweeps = PJ, PJ.degeneracy_projector, []

    def __enter__(self):
        def tallied(H, nmatch, *args):
            if H.device.type == "cpu":
                return self.real(H, nmatch, *args)
            P, n_con, sw = self.PJ.projector_cuda(H, nmatch, *args, sweeps=True)
            self.sweeps.append(sw.reshape(-1))
            return P, n_con

        self.PJ.degeneracy_projector = tallied
        return self

    def __exit__(self, *exc):
        self.PJ.degeneracy_projector = self.real

    def counts(self):
        """{matrices, jacobi (took at least one sweep), sweeps (sum),
        sweeps_max} over the phase."""
        import torch

        if not self.sweeps:
            return {"matrices": 0, "jacobi": 0, "sweeps": 0, "sweeps_max": 0}
        torch.cuda.synchronize()
        sw = torch.cat(self.sweeps).cpu()
        return {"matrices": sw.numel(), "jacobi": int((sw > 0).sum()), "sweeps": int(sw.sum()),
                "sweeps_max": int(sw.max())}


def time_projector(PJ, H, m, params, sweeps, screened, empty_ms):
    """Kernel, plain version and ``torch.linalg.eigh`` alone on the same
    inputs, in turns, beside the bound and an empty launch."""
    import torch

    args = (params.damping, params.degen_rel, params.degen_thresh)
    eye = torch.eye(6, dtype=torch.float64, device=H.device)
    A = H.to(torch.float64) + params.damping * eye

    def kern():
        return PJ.projector_cuda(H, m, *args)

    def plain():
        return PJ.projector_plain(H, m, *args)

    def lib():
        return torch.linalg.eigh(A)

    B = H.numel() // 36
    iters = 100 if B == 1 else 20
    row = {"B": B, "sweeps_max": int(sweeps.max()), "screened": int(screened.sum())}
    p1, k1, l1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kern, lib, kern, plain))
    bound, by = projector_bound_ms(B, int(screened.sum()))
    row.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=l1, bound_ms=bound,
               bound_by=by, empty_launch_ms=empty_ms, call_ms=cuda_ms(kern, iters, queued=False))
    return row


def phase_projector(scans):
    """The projector kernel (``projector_cuda``) against ``projector_plain``
    on the card and against its CPU model: at the registration's own normal
    matrices from fused frames 1 and 2, at corner cases, at the boundary
    batch, and over a batch of random normal matrices; then timed on a
    screened path matrix (one a launch), on the corridor (the Jacobi path)
    and on the batch beside ``torch.linalg.eigh`` alone, the plain version,
    the bound and an empty launch."""
    import torch

    from lmsf_slam_tpu_torch.ops import knn as K
    from lmsf_slam_tpu_torch.ops import projector as PJ

    dev = torch.device("cuda")
    captured, params = capture_normal_matrices(scans)
    check(len(captured) == 2 * PROJECTOR_PER_FRAME,
          f"captured {len(captured)} normal matrices from 2 frames, expected "
          f"{2 * PROJECTOR_PER_FRAME}")
    rows, errs, sweeps, screened = {}, [], [], []
    for H, nmatch in captured:  # one matrix a launch, as the path launches
        err, sw, scr = compare_projector(PJ, H, nmatch, params)
        errs.append(err)
        sweeps.append(int(sw[0]))
        screened.append(bool(scr[0]))
    # the Jacobi path on the same matrices: the sweeps the screen saves
    jacobi_sweeps = [int(PJ.projector_jacobi_plain(H.cpu()[None], m.cpu()[None], params.damping,
                                                   params.degen_rel, params.degen_thresh,
                                                   screen=False)[2][0]) for H, m in captured]
    n_con = [int(PJ.projector_cuda(H, m, params.damping, params.degen_rel,
                                   params.degen_thresh)[1]) for H, m in captured]
    rows["frames"] = {"matrices": len(captured), "max_abs_err": max(errs), "sweeps": sweeps,
                      "n_constrained": n_con, "screened": sum(screened),
                      "jacobi_sweeps_without_screen": jacobi_sweeps}
    log("projector", f"{len(captured)} normal matrices of fused frames 1 and 2, one a launch: equal "
        f"counts ({n_con}), max |ΔP| {max(errs):.3g} (limit {PROJECTOR_AGREE}); "
        f"{sum(screened)} of {len(captured)} screened (P = I); kernel sweeps {sweeps}, equal to the "
        f"CPU model's; without the screen Jacobi would take {jacobi_sweeps}")

    g = np.random.default_rng(11)
    H0, m0 = captured[0]
    corridor = g.standard_normal((400, 6))
    corridor[:, 3] *= 1e-4  # no constraint along x: one direction under the floor
    cases = {
        "non-finite": (torch.full((6, 6), float("nan"), device=dev), m0),
        "corridor": (torch.as_tensor(corridor.T @ corridor * 50.0, dtype=torch.float32,
                                     device=dev), torch.tensor(400, dtype=torch.int32,
                                                               device=dev)),
        "isotropic": (torch.eye(6, device=dev) * 1000.0, m0),
        "absolute floor": (H0, None),
        "zero": (torch.zeros((6, 6), device=dev), m0),
    }
    for name, (H, m) in cases.items():
        err, sw, scr = compare_projector(PJ, H, m, params)
        rows[name] = {"max_abs_err": err, "sweeps": int(sw[0]), "screened": bool(scr[0])}
        errs.append(err)
    boundary, eigh_off = projector_boundary_cases(dev), []
    for name, (H, m, p) in boundary.items():
        # the eigenvalues are the diagonal, exactly: the plain version on the
        # CPU and the exact count, not cuSOLVER's rounding at the tie
        err, sw, scr = compare_projector(PJ, H, m, p, plain_on_cpu=True)
        check(tuple(scr.tolist()) == PROJECTOR_BOUNDARY_SCREENED,
              f"boundary batch {name}: screened {scr.tolist()}, expected "
              f"{list(PROJECTOR_BOUNDARY_SCREENED)}")
        n_con = PJ.projector_cuda(H, m, p.damping, p.degen_rel, p.degen_thresh)[1]
        check(torch.equal(n_con, projector_exact_count(H, m, p)),
              f"boundary batch {name}: counts {n_con.tolist()} differ from the exact ones")
        n_card = PJ.projector_plain(H, m, p.damping, p.degen_rel, p.degen_thresh)[1]
        eigh_off += [f"{name}: {n_card.tolist()}"] if not torch.equal(n_card, n_con) else []
        rows[name] = {"max_abs_err": err, "screened": int(scr.sum()),
                      "n_constrained": n_con.tolist(), "plain_on_card": n_card.tolist()}
        errs.append(err)
    J = g.standard_normal((PROJECTOR_BATCH, 64, 6))
    J[: PROJECTOR_BATCH // 4, :, g.integers(0, 6)] *= 1e-3  # a quarter degenerate
    Hb = torch.as_tensor(np.einsum("bki,bkj->bij", J, J) * g.uniform(1, 400, (PROJECTOR_BATCH, 1, 1)),
                         dtype=torch.float32, device=dev)
    mb = torch.as_tensor(g.integers(50, 4000, PROJECTOR_BATCH), dtype=torch.int32, device=dev)
    err, sw_b, scr_b = compare_projector(PJ, Hb, mb, params)
    rows[f"batch {PROJECTOR_BATCH}"] = {"max_abs_err": err, "sweeps_max": int(sw_b.max()),
                                        "screened": int(scr_b.sum())}
    errs.append(err)
    log("projector", "corner cases (non-finite, a corridor with one direction under the floor, "
        "isotropic, the absolute floor, zero), the boundary batch (3 floors x at, under, over the "
        f"rounding midpoint) and a batch of {PROJECTOR_BATCH} random normal matrices in one "
        "launch: equal counts, sweeps and screen decisions equal to the CPU model's; max |ΔP| "
        + ", ".join(f"{k} {v['max_abs_err']:.3g}" for k, v in rows.items() if k != "frames"))
    log("projector", "boundary batch counts (5 matrices each): " + "; ".join(
        f"{k}: {rows[k]['n_constrained']}" for k in PROJECTOR_BOUNDARY)
        + f"; the batch of {PROJECTOR_BATCH}: {int(scr_b.sum())} screened, Jacobi sweeps at "
        f"most {int(sw_b.max())}")
    log("projector", "the plain version on the card (cuSOLVER) at the boundary batch: "
        + ("; ".join(eigh_off) + " (off the exact count at the tie)" if eigh_off
           else "the exact counts everywhere"))

    # timed: a screened path matrix (one a launch, as the path launches), the
    # corridor (the Jacobi path) and the batch
    empty_ms = cuda_ms(K.empty_launch_cuda, 200)
    check(any(screened), "the screen passed none of the path's matrices")
    mid = screened.index(True)
    H, m = captured[mid]
    Hc, mc = cases["corridor"]
    timed = {
        "path": time_projector(PJ, H, m, params, torch.tensor([sweeps[mid]]),
                               torch.tensor([True]), empty_ms),
        "corridor": time_projector(PJ, Hc, mc, params, torch.tensor([rows["corridor"]["sweeps"]]),
                                   torch.tensor([False]), empty_ms),
        "batch": time_projector(PJ, Hb, mb, params, sw_b, scr_b, empty_ms),
    }
    for name, r in timed.items():
        log("projector", f"{name} ({r['B']} matrices, {r['screened']} screened, at most "
            f"{r['sweeps_max']} sweeps): kernel {r['ms']:.4f} ms ({r['call_ms']:.4f} ms a call at "
            f"Python's pace), plain {r['plain_ms']:.4f} ms, torch.linalg.eigh alone {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.3g} ms ({r['bound_by']}), empty launch {empty_ms:.5f} ms")
    path = timed["path"]
    return {"cases": rows, "max_abs_err": max(errs), "timed": timed,
            "ms": path["ms"], "plain_ms": path["plain_ms"], "library_ms": path["library_ms"],
            "bound_ms": path["bound_ms"], "bound_by": path["bound_by"], "call_ms": path["call_ms"],
            "ms_jacobi": timed["corridor"]["ms"], "empty_launch_ms": empty_ms,
            "screened": sum(screened)}


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------


def make_course():
    from lmsf_slam_tpu_torch.datasets import make_sim_world, make_trajectory, simulate_scan

    rng = np.random.default_rng(0)
    world = make_sim_world(rng, extent=18.0, n_boxes=8, n_cylinders=14)
    traj = make_trajectory(N_FRAMES, radius=6.0, loop=False, device="cpu").numpy().copy()
    traj[:, 6] = 1.2  # lift the sensor to 1.2 m
    # scans arrive in host memory, as from a driver; each frame's step copies
    # its scan to the card
    scans = [simulate_scan(world, traj[i], rng, device="cpu") for i in range(N_FRAMES)]
    return traj, scans


def run_frames(step, state, scans, gate_cfg, n, on_frame=None):
    from lmsf_slam_tpu_torch.system import KeyframeGate, read_frame

    gate = KeyframeGate(*gate_cfg)
    results, times = [], []
    for i in range(n):
        s = scans[i]
        t0 = time.perf_counter()
        state, out, _, _, _ = step(state, s.xyz, s.mask, s.attr, 0.1 * i)
        results.append(read_frame(out, gate, 0.1 * i))
        times.append(time.perf_counter() - t0)
        if on_frame is not None:
            on_frame(i)
    return state, results, times


def phase_slice(traj, scans):
    import torch

    from lmsf_slam_tpu_torch import _build
    from lmsf_slam_tpu_torch.common import se3np
    from lmsf_slam_tpu_torch.evaluation import ate_stats
    from lmsf_slam_tpu_torch.system import SystemConfig, build_fused_step
    from lmsf_slam_tpu_torch.tracker import tracker_init

    cfg = SystemConfig()
    gate_cfg = (cfg.keyframe_trans, cfg.keyframe_rot, cfg.keyframe_dt)
    tc, step = build_fused_step(cfg, "cuda")
    state = tracker_init(tc, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    _, results, times = run_frames(step, state, scans, gate_cfg, N_FRAMES)
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()

    est = np.stack([r.odom_pose for r in results])
    check(np.isfinite(est).all(), "non-finite pose on the card")
    gt = np.stack([se3np.pose_between(traj[0], traj[i]) for i in range(N_FRAMES)])
    ate = ate_stats(est, gt).rmse
    check(ate < ATE_LIMIT, f"ATE {ate:.4f} m ≥ {ATE_LIMIT} m")
    want = KNN_PER_FRAME * N_FRAMES
    for name in ("knn", "knn_merge"):  # every association is split, so each has its merge
        check(launches.get(name, 0) == want,
              f"{name} launches {launches.get(name, 0)} on the main path, expected {want}")
    want = PROJECTOR_PER_FRAME * N_FRAMES
    check(launches.get("projector", 0) == want,
          f"projector launches {launches.get('projector', 0)} on the main path, expected {want}")

    # the same port on the CPU (plain k-NN) over the first frames
    tc_cpu, step_cpu = build_fused_step(cfg, "cpu")
    _, res_cpu, times_cpu = run_frames(
        step_cpu, tracker_init(tc_cpu, "cpu"), scans, gate_cfg, N_CPU_FRAMES
    )
    est_cpu = np.stack([r.odom_pose for r in res_cpu])
    dev_cpu = float(np.max(np.abs(est_cpu - est[:N_CPU_FRAMES])))
    check(dev_cpu < CPU_AGREE, f"card vs CPU pose differ by {dev_cpu:.3g} over "
          f"{N_CPU_FRAMES} frames (limit {CPU_AGREE})")

    ms = np.asarray(times) * 1e3
    out = {
        "frames": N_FRAMES, "ate_rmse_m": ate, "knn_launches": launches.get("knn", 0),
        "knn_merge_launches": launches.get("knn_merge", 0),
        "projector_launches": launches.get("projector", 0),
        "frame_ms_median": float(np.median(ms)), "frame_ms_p90": float(np.percentile(ms, 90)),
        "frame_ms_first": float(ms[0]), "frame_ms_all": ms.tolist(),
        "cpu_frame_ms_median": float(np.median(np.asarray(times_cpu) * 1e3)),
        "cpu_max_abs_pose_diff": dev_cpu, "peak_device_bytes": int(peak),
        "keyframes": int(sum(r.is_keyframe for r in results)),
        "num_matches_median": float(np.median([r.num_matches for r in results])),
    }
    log("slice", f"{N_FRAMES} frames: ATE {ate:.4f} m (limit {ATE_LIMIT}); "
        f"ms/frame median {out['frame_ms_median']:.2f}, p90 {out['frame_ms_p90']:.2f} "
        f"(first {ms[0]:.1f}); knn launches {out['knn_launches']} "
        f"({out['knn_launches'] / N_FRAMES:g}/frame), knn_merge launches "
        f"{out['knn_merge_launches']}, projector launches {out['projector_launches']}; peak "
        f"device memory "
        f"{peak / 2**20:.1f} MiB; card vs CPU over {N_CPU_FRAMES} frames max |Δpose| "
        f"{dev_cpu:.3g}; keyframes {out['keyframes']}")
    return out


def profile_counts(prof, n):
    """What a ``torch.profiler`` trace over ``n`` frames shows a frame:
    device rows (name, ms, calls), device ms, device events, device-to-host
    and host-to-device copies, and host waits (``cudaStreamSynchronize``:
    a read-back, or a copy from pageable host memory, waits for the card).
    Busy time sums the device-side events (kernels, copies) only: a host
    op's row repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType

    rows, dtoh, htod, waits = [], 0, 0, 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            if ev.key == "cudaStreamSynchronize":
                waits += ev.count
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and dev_us > 0:
            rows.append((ev.key, dev_us / 1e3 / n, ev.count / n))
        if "Memcpy DtoH" in ev.key:
            dtoh += ev.count
        elif "Memcpy HtoD" in ev.key:
            htod += ev.count
    rows.sort(key=lambda x: -x[1])
    return {"rows": rows, "device_ms": sum(r[1] for r in rows),
            "device_events": sum(r[2] for r in rows), "dtoh": dtoh / n, "htod": htod / n,
            "waits": waits / n}


def phase_profile(scans, frame_ms):
    """Device time per frame and its largest kernels, over frames 2..6 of a
    fresh run (torch.profiler; "not measured" where it reports no device
    time; :func:`profile_counts`), with the copies and host waits a frame.
    The busy share is taken of ``frame_ms``, the unprofiled median frame
    time, since the profiler slows the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lmsf_slam_tpu_torch.system import SystemConfig, build_fused_step
    from lmsf_slam_tpu_torch.tracker import tracker_init

    cfg = SystemConfig()
    gate_cfg = (cfg.keyframe_trans, cfg.keyframe_rot, cfg.keyframe_dt)
    tc, step = build_fused_step(cfg, "cuda")
    state, _, _ = run_frames(step, tracker_init(tc, "cuda"), scans, gate_cfg, 2)
    n = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_frames(step, state, scans[2:], gate_cfg, n)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    counts = profile_counts(prof, n)
    rows = counts["rows"]
    if not rows:
        log("profile", "device time: not measured (the profiler reported none)")
        return {"device_ms_per_frame": None}
    total = counts["device_ms"]
    knn_ms = sum(r[1] for r in rows if "knn_partial_kernel" in r[0] or "knn_merge_kernel" in r[0])
    launches = counts["device_events"]
    check(knn_ms > 0, "the profile shows no k-NN kernel on the device")
    proj_ms = sum(r[1] for r in rows if "projector_kernel" in r[0])
    check(proj_ms > 0, "the profile shows no projector kernel on the device")
    check(counts["dtoh"] == 1, f"the fused frame copied {counts['dtoh']:g} times a frame from the "
          "card, not once (its read-back)")
    check(launches < EARLIER_EVENTS_PER_FRAME,
          f"{launches:g} device events a frame, not fewer than {EARLIER_EVENTS_PER_FRAME} "
          "(the one-thread-a-query kernel)")
    top = "; ".join(f"{k[:48]} {ms:.3f} ms ×{c:g}" for k, ms, c in rows[:6])
    log("profile", f"per frame: device busy {total:.3f} ms = {100 * total / frame_ms:.1f}% of "
        f"the {frame_ms:.2f} ms median frame (idle {100 - 100 * total / frame_ms:.1f}%), "
        f"{launches:g} device events (one-thread-a-query kernel: {EARLIER_EVENTS_PER_FRAME}); knn kernels "
        f"{knn_ms:.3f} ms (one-thread-a-query kernel: {EARLIER_KNN_MS_PER_FRAME}); projector kernel "
        f"{proj_ms:.4f} ms (the one-thread Jacobi kernel: {EARLIER_PROJECTOR_MS_PER_FRAME}); profiled wall "
        f"{wall:.2f} ms; device-to-host copies {counts['dtoh']:g}, host-to-device copies "
        f"{counts['htod']:g}, host waits (cudaStreamSynchronize) {counts['waits']:g}; top: {top}")
    return {"profiled_wall_ms_per_frame": wall, "device_ms_per_frame": total,
            "device_busy_share": total / frame_ms, "device_events_per_frame": launches,
            "dtoh_per_frame": counts["dtoh"], "htod_per_frame": counts["htod"],
            "host_waits_per_frame": counts["waits"], "knn_device_ms_per_frame": knn_ms,
            "projector_device_ms_per_frame": proj_ms,
            "kernels": [{"name": k, "ms_per_frame": ms, "calls_per_frame": c}
                        for k, ms, c in rows[:25]]}


# ---------------------------------------------------------------------------
# phases 5 and 6: the whole system with the lifelong backend, and a reboot
# ---------------------------------------------------------------------------


def backend_config():
    """The looped simulator course's configuration at full width: default
    features (16 × 900, 384 edge + 1536 surf), gates scaled to a 120-frame
    circle (a loop may close after 20 keyframes)."""
    from lmsf_slam_tpu_torch.backend import LifelongConfig, LoopConfig
    from lmsf_slam_tpu_torch.ops.registration import RegistrationParams
    from lmsf_slam_tpu_torch.system import FeatureParams, SystemConfig

    return SystemConfig(
        feature=FeatureParams(rings=16, width=900),
        registration=RegistrationParams(max_iters=8, max_corr_dist=2.0),
        map_update_trans=0.2,
        keyframe_trans=0.8,
        lifelong=LifelongConfig(optimize_window=50),
        loop=LoopConfig(min_frame_interval=20, exclude_recent=10, detect_spacing=1,
                        search_radius=6.0, adjacent_window=3, refine_score_thresh=0.3),
    )


def make_loop_course(seed=LOOP_SEED, n_frames=LOOP_FRAMES):
    """Ground truth and scans (in host memory) of the closed course."""
    from lmsf_slam_tpu_torch.datasets import make_sim_world, make_trajectory, simulate_scan

    rng = np.random.default_rng(seed)
    world = make_sim_world(rng, extent=30.0, n_boxes=14, n_cylinders=24)
    traj = make_trajectory(n_frames, radius=9.0, loop=True, device="cpu").numpy().copy()
    traj[:, 6] = 1.4
    scans = [simulate_scan(world, traj[i], rng, rings=16, width=900, max_range=60.0, noise=0.01,
                           device="cpu") for i in range(n_frames)]
    return traj, scans


def drive(system, scans, stamps, stop=None):
    """Feed scans through ``system.process``; returns (results, seconds a
    frame). ``stop(system, result)`` true ends the run after that frame."""
    results, times = [], []
    for scan, t in zip(scans, stamps):
        t0 = time.perf_counter()
        res = system.process(scan, t)
        times.append(time.perf_counter() - t0)
        results.append(res)
        if stop is not None and stop(system, res):
            break
    return results, times


def mirror_nbytes(db):
    m = db._mirror_sync()
    return int(sum(v.numel() * v.element_size() for v in m.values() if hasattr(v, "numel")))


def time_solve(backend, repeats=3):
    """What a full pose-graph solve of the database's graph costs on the
    card (host clock around a solve that ends in a read-back); the poses are
    not written back."""
    import torch

    from lmsf_slam_tpu_torch.backend import optimize_pose_graph
    from lmsf_slam_tpu_torch.backend.pose_graph import _edge_res_jac

    cfg, db = backend.config, backend.db
    g = db.graph_arrays(pad_min=cfg.graph_pad_min)
    ms, jac_ms, stats = [], [], None
    pi, pj = g.poses[g.edges_ij[:, 0].long()], g.poses[g.edges_ij[:, 1].long()]
    for _ in range(repeats):  # the edge Jacobians alone: the start of every GN iteration
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _edge_res_jac(pi, pj, g.edges_z)
        torch.cuda.synchronize()
        jac_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses, stats = optimize_pose_graph(g.poses, g.vmask, g.edges_ij, g.edges_z, g.edges_sqrtw,
                                           g.emask, edges_robust=g.erobust, params=cfg.pose_graph)
        poses.cpu()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"vertices": int(db.n_keyframes), "edges": int(db.n_edges),
            "padded_vertices": int(g.poses.shape[0]), "padded_edges": int(g.emask.shape[0]),
            "ms": ms, "ms_median": float(np.median(ms)), "iterations": int(stats.iterations),
            "jacobians_ms": jac_ms, "jacobians_ms_median": float(np.median(jac_ms)),
            "chi2_initial": float(stats.chi2_initial), "chi2_final": float(stats.chi2_final)}


def phase_backend(traj, scans):
    import torch

    from lmsf_slam_tpu_torch import _build
    from lmsf_slam_tpu_torch.backend import WorkMode
    from lmsf_slam_tpu_torch.common import se3np
    from lmsf_slam_tpu_torch.evaluation import ate_stats
    from lmsf_slam_tpu_torch.system import MultiLidarSystem

    cfg = backend_config()
    n = len(scans)
    stamps = [0.1 * i for i in range(n)]
    system = MultiLidarSystem(cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    first_kf = {}
    solves = []  # (keyframes stored, loop closed, solver runs) after every keyframe frame
    corrections = [np.asarray(system.backend.odom2map).copy()]  # before and after each frame

    def snapshot(sys_, res):
        # the first keyframes' map poses, when the last of them is stored
        if sys_.backend.db.n_keyframes == N_CPU_KEYFRAMES and not first_kf:
            first_kf["poses"] = sys_.keyframe_trajectory()
        if res.is_keyframe:
            solves.append((sys_.backend.db.n_keyframes, res.loop_closed,
                           dict(sys_.backend.solver_runs)))
        corrections.append(np.asarray(sys_.backend.odom2map).copy())
        return False

    results, times = drive(system, scans, stamps, stop=snapshot)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    backend = system.backend
    db = backend.db

    est = system.trajectory()
    odom = np.stack([r.odom_pose for r in results])
    check(len(results) == n and np.isfinite(est).all() and np.isfinite(odom).all(),
          "non-finite pose on the card")
    n_kf_frames = sum(r.is_keyframe for r in results)
    check(db.n_keyframes >= 20, f"only {db.n_keyframes} keyframes stored")
    closed = [i for i, r in enumerate(results) if r.loop_closed]
    check(len(closed) >= 1, "no loop closed on the looped course")
    check(all(r.mode is WorkMode.MAPPING for r in results[:closed[0]])
          and results[closed[0]].mode is WorkMode.LOCALIZATION,
          "the mode did not go MAPPING → LOCALIZATION at the loop closure")
    runs = dict(backend.solver_runs)
    check(runs["full_replicated"] >= 1, f"no full solve ran: {runs}")
    # a solve that no loop closure asked for is windowed once more than
    # optimize_window + 1 keyframes are stored
    for (_, _, before), (n_kf, loop, after) in zip(solves, solves[1:]):
        if sum(after.values()) > sum(before.values()) and not loop and (
                n_kf > cfg.lifelong.optimize_window + 1):
            check(after["windowed"] == before["windowed"] + 1,
                  f"the solve at {n_kf} keyframes was not windowed: {before} → {after}")
    gt = np.stack([se3np.pose_between(traj[0], traj[i]) for i in range(n)])
    ate_map, ate_odom = ate_stats(est, gt).rmse, ate_stats(odom, gt).rmse
    check(ate_map < ATE_LIMIT, f"map-frame ATE {ate_map:.4f} m ≥ {ATE_LIMIT} m")
    check(ate_map <= ate_odom + ODOM_ATE_SLACK,
          f"map-frame ATE {ate_map:.4f} m worse than odometry's {ate_odom:.4f} m")
    per_frame = 2 * 4  # max_iters=8: 4 associations × (edge + surf) a frame
    for name in ("knn", "knn_merge"):  # the frames' associations and the backend's on top
        check(launches.get(name, 0) > per_frame * n,
              f"{name}: {launches.get(name, 0)} launches on the backend path, the frames "
              f"alone make {per_frame * n}")
    check(launches.get("projector", 0) > per_frame // 2 * n,
          f"projector: {launches.get('projector', 0)} launches on the backend path, the frames "
          f"alone make {per_frame // 2 * n}")
    knn_backend = launches["knn"] - per_frame * n

    # the same course on the CPU (plain k-NN) until the first keyframes are stored
    cpu = MultiLidarSystem(cfg, device="cpu")
    _, times_cpu = drive(cpu, scans, stamps,
                         stop=lambda s, r: s.backend.db.n_keyframes >= N_CPU_KEYFRAMES)
    check("poses" in first_kf, "the card run stored fewer keyframes than compared")
    kf_card, kf_cpu = first_kf["poses"], cpu.keyframe_trajectory()
    check(kf_cpu.shape == kf_card.shape, "card and CPU stored different keyframes")
    dev_cpu = float(np.max(np.abs(kf_card - kf_cpu)))
    check(dev_cpu < CPU_AGREE, f"card vs CPU keyframe map poses differ by {dev_cpu:.3g} "
          f"(limit {CPU_AGREE})")

    solve = time_solve(backend)
    ms = np.asarray(times) * 1e3
    is_kf = np.asarray([r.is_keyframe for r in results])
    stats = backend.timer.stats()
    out = {
        "solve": solve,
        "frames": n, "keyframe_frames": int(n_kf_frames), "keyframes_stored": int(db.n_keyframes),
        "edges": int(db.n_edges), "loops_closed": len(closed), "first_loop_frame": closed[0],
        "loop_edges": db.eij[:db.n_edges][db.eloop[:db.n_edges]].tolist(),
        "final_mode": backend.mode.name, "solver_runs": runs, "solves": backend.solve_log,
        "ate_map_m": ate_map, "ate_odom_m": ate_odom,
        "frame_ms_median": float(np.median(ms)), "frame_ms_p90": float(np.percentile(ms, 90)),
        "frame_ms_median_no_kf": float(np.median(ms[~is_kf])),
        "frame_ms_p90_no_kf": float(np.percentile(ms[~is_kf], 90)),
        "frame_ms_median_kf": float(np.median(ms[is_kf])),
        "frame_ms_p90_kf": float(np.percentile(ms[is_kf], 90)),
        "frame_ms_max": float(ms.max()), "frame_ms_all": ms.tolist(),
        "is_keyframe": is_kf.tolist(), "stage_ms": stats,
        "knn_launches": launches["knn"], "knn_merge_launches": launches["knn_merge"],
        "projector_launches": launches["projector"],
        "knn_launches_per_backend_keyframe": knn_backend / max(n_kf_frames, 1),
        "mirror_bytes": mirror_nbytes(db), "mirror_rows": int(db._mirror["cap"]),
        "peak_device_bytes": int(peak), "cpu_keyframes_max_abs_pose_diff": dev_cpu,
        "cpu_frame_ms_median": float(np.median(np.asarray(times_cpu) * 1e3)),
        # what phase async holds its run to
        "odom_poses": odom.tolist(), "keyframe_map_poses": system.keyframe_trajectory().tolist(),
        "odom2map_before_and_after_each_frame": np.stack(corrections).tolist(),
    }
    log("backend", f"{n} frames, {n_kf_frames} through the gate, {db.n_keyframes} keyframes and "
        f"{db.n_edges} edges stored; loops closed {len(closed)} (first at frame {closed[0]}, "
        f"edges {out['loop_edges']}), mode MAPPING → {backend.mode.name}; solver runs {runs}")
    log("backend", f"ATE map frame {ate_map:.4f} m, odometry alone {ate_odom:.4f} m (limit "
        f"{ATE_LIMIT}); first {N_CPU_KEYFRAMES} keyframes card vs CPU max |Δpose| {dev_cpu:.3g}")
    log("backend", f"ms/frame median {out['frame_ms_median']:.2f}, p90 {out['frame_ms_p90']:.2f}, "
        f"max {out['frame_ms_max']:.1f}; frames without a keyframe median "
        f"{out['frame_ms_median_no_kf']:.2f}, p90 {out['frame_ms_p90_no_kf']:.2f}; keyframe frames "
        f"median {out['frame_ms_median_kf']:.2f}, p90 {out['frame_ms_p90_kf']:.2f}")
    log("backend", "stage ms (n, mean, median, max): " + "; ".join(
        f"{k} {v['n']}, {v['mean_ms']:.2f}, {v['median_ms']:.2f}, {v['max_ms']:.2f}"
        for k, v in sorted(stats.items())))
    log("backend", f"a full solve of the final graph ({solve['vertices']} vertices and "
        f"{solve['edges']} edges padded to {solve['padded_vertices']} and "
        f"{solve['padded_edges']}): {solve['ms_median']:.1f} ms (median of {len(solve['ms'])}), "
        f"{solve['iterations']} GN iterations, chi2 {solve['chi2_initial']:.4g} → "
        f"{solve['chi2_final']:.4g}; the edge Jacobians alone {solve['jacobians_ms_median']:.1f} ms")
    log("backend", "GN iterations a solve: " + ", ".join(
        f"{s_['kind']}@{s_['keyframes']}:{s_['iterations']}" for s_ in backend.solve_log))
    log("backend", f"knn launches {launches['knn']} (+{launches['knn_merge']} merges): "
        f"{per_frame} a frame and {out['knn_launches_per_backend_keyframe']:.1f} more a keyframe "
        f"frame; mirror {out['mirror_bytes'] / 2**20:.2f} MiB in {out['mirror_rows']} rows; peak "
        f"device memory {peak / 2**20:.1f} MiB")
    return out, system


def phase_reboot(traj, scans, first):
    """A second run on the first one's database: boots in RELOCALIZATION,
    relocalizes by appearance, then localizes against the stored map."""
    import torch

    from lmsf_slam_tpu_torch import _build
    from lmsf_slam_tpu_torch.backend import LifelongBackend, WorkMode
    from lmsf_slam_tpu_torch.common import se3np
    from lmsf_slam_tpu_torch.system import MultiLidarSystem

    cfg = backend_config()
    backend = LifelongBackend(db=first.backend.db, config=cfg.lifelong, loop_config=cfg.loop)
    check(backend.mode is WorkMode.RELOCALIZATION, "a backend on a filled database must boot "
          "in RELOCALIZATION")
    system = MultiLidarSystem(cfg, backend=backend, device="cuda")
    frames = range(REBOOT_START, REBOOT_START + REBOOT_FRAMES)
    _build.reset_launches()
    results, times = drive(system, [scans[i] for i in frames], [100.0 + 0.1 * i for i in frames])
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for name in ("knn", "knn_merge", "projector"):
        check(launches.get(name, 0) > 0, f"{name} was not launched on the reboot path")
    localized = [k for k, r in enumerate(results) if r.mode is not WorkMode.RELOCALIZATION]
    check(bool(localized), "the rebooted system never relocalized")
    kf_before = sum(r.is_keyframe for r in results[:localized[0] + 1])
    check(kf_before <= REBOOT_KEYFRAMES,
          f"relocalized only after {kf_before} keyframes (limit {REBOOT_KEYFRAMES})")
    gt = np.stack([se3np.pose_between(traj[0], traj[i]) for i in frames])
    est = np.stack([r.map_pose for r in results])
    check(np.isfinite(est).all(), "non-finite pose after the reboot")
    err = np.linalg.norm(est[localized[0]:, 4:] - gt[localized[0]:, 4:], axis=1)
    check(float(err.max()) < REBOOT_LIMIT,
          f"after relocalizing, the map pose lies {err.max():.3f} m from the ground truth "
          f"(limit {REBOOT_LIMIT})")
    stats = backend.timer.stats()
    out = {
        "start_frame": REBOOT_START, "frames": len(results),
        "relocalized_at_frame": REBOOT_START + localized[0],
        "keyframes_until_relocalized": int(kf_before),
        "map_err_rmse_m": float(np.sqrt(np.mean(err ** 2))), "map_err_max_m": float(err.max()),
        "modes": [r.mode.name for r in results], "history": [
            (h.mode.name, h.keyframe_id, h.score, h.overlap) for h in backend.history],
        "stage_ms": stats, "knn_launches": launches["knn"],
        "knn_merge_launches": launches["knn_merge"], "projector_launches": launches["projector"],
        "frame_ms_median": float(np.median(np.asarray(times) * 1e3)),
    }
    log("reboot", f"booted in RELOCALIZATION on {backend.db.n_keyframes} keyframes; fed frames "
        f"{REBOOT_START}..{REBOOT_START + len(results) - 1}: relocalized at frame "
        f"{out['relocalized_at_frame']} after {kf_before} keyframe(s); map pose vs ground truth in "
        f"the map frame rmse {out['map_err_rmse_m']:.3f} m, max {out['map_err_max_m']:.3f} m "
        f"(limit {REBOOT_LIMIT}); final mode {results[-1].mode.name}; stage ms (n, mean): "
        + "; ".join(f"{k} {v['n']}, {v['mean_ms']:.2f}" for k, v in sorted(stats.items())))
    return out


# ---------------------------------------------------------------------------
# phase 7: the worker-thread backend on the closed course
# ---------------------------------------------------------------------------


def frame_stats(times, is_kf):
    ms = np.asarray(times) * 1e3
    is_kf = np.asarray(is_kf, bool)
    return {
        "frame_ms_median": float(np.median(ms)), "frame_ms_p90": float(np.percentile(ms, 90)),
        "frame_ms_max": float(ms.max()), "frame_ms_first": float(ms[0]),
        "frame_ms_max_after_first": float(ms[1:].max()),
        "frame_ms_median_kf": float(np.median(ms[is_kf])), "frame_ms_max_kf": float(ms[is_kf].max()),
        "frame_ms_median_no_kf": float(np.median(ms[~is_kf])),
        "frame_ms_all": ms.tolist(), "is_keyframe": is_kf.tolist(),
    }


def stage_line(stats):
    return "; ".join(f"{k} {v['n']}, {v['mean_ms']:.2f}, {v['median_ms']:.2f}, {v['max_ms']:.2f}"
                     for k, v in sorted(stats.items()))


def phase_async(traj, scans, sync):
    """The closed course with the backend on its worker thread, beside the
    sync run of phase backend (``sync``: that phase's numbers)."""
    import torch

    from lmsf_slam_tpu_torch import _build
    from lmsf_slam_tpu_torch.common import se3np
    from lmsf_slam_tpu_torch.evaluation import ate_stats
    from lmsf_slam_tpu_torch.system import MultiLidarSystem

    cfg = backend_config()._replace(async_backend=True, async_policy="coalesce")
    n = len(scans)
    system = MultiLidarSystem(cfg, device="cuda")
    torch.cuda.synchronize()
    _build.reset_launches()
    backlog = []
    results, times = drive(system, scans, [0.1 * i for i in range(n)],
                           stop=lambda s, r: backlog.append(s._async.backlog))
    t0 = time.perf_counter()
    system.flush()
    flush_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    ab, backend, db = system._async, system.backend, system.backend.db
    est = system.trajectory()
    check(np.isfinite(est).all(), "non-finite pose with the async backend")
    check(ab.dropped == 0, f"the async backend dropped {ab.dropped} keyframes")
    loop_edges = db.eij[:db.n_edges][db.eloop[:db.n_edges]].tolist()
    check(loop_edges == sync["loop_edges"],
          f"async closed loops {loop_edges}, the sync run {sync['loop_edges']}")
    check(backend.mode.name == sync["final_mode"],
          f"async ended in {backend.mode.name}, the sync run in {sync['final_mode']}")
    gt = np.stack([se3np.pose_between(traj[0], traj[i]) for i in range(n)])
    ate = ate_stats(est, gt).rmse
    check(ate < ATE_LIMIT, f"async map-frame ATE {ate:.4f} m ≥ {ATE_LIMIT} m")
    # A frame takes the latest correction the worker has published, so the
    # corrections reach the frames as late as the worker lags, which the
    # host's speed sets: the frames' ATE lies between the sync run's and
    # odometry's accordingly. What holds whatever the lag: the front end's
    # odometry is the sync run's, the database after the flush holds the sync
    # run's keyframe map poses, and every frame's correction is one that the
    # sync run had published by that frame. A coalesced localization refresh
    # (possible only after the loop closure) changes what follows it.
    odom = np.stack([r.odom_pose for r in results])
    odom_dev = float(np.max(np.abs(odom - np.asarray(sync["odom_poses"]))))
    check(odom_dev < CPU_AGREE, f"async odometry {odom_dev:.3g} from the sync run's "
          f"(limit {CPU_AGREE})")
    sync_corr = np.asarray(sync["odom2map_before_and_after_each_frame"])
    upto = n if ab.coalesced == 0 else sync["first_loop_frame"]
    lag, corr_dev = [], []
    for f in range(upto):
        corr = se3np.pose_compose(results[f].map_pose, se3np.pose_inverse(odom[f]))
        dev = np.max(np.abs(sync_corr[:f + 2] - corr), axis=1)  # published by frame f
        g = int(np.flatnonzero(dev == dev.min())[-1])
        lag.append(f + 1 - g)
        corr_dev.append(float(dev[g]))
    check(max(corr_dev) < CPU_AGREE,
          f"frame {int(np.argmax(corr_dev))}'s correction is {max(corr_dev):.3g} from every "
          f"correction the sync run had published by then (limit {CPU_AGREE})")
    kf_dev = None
    if ab.coalesced == 0:
        kf_sync = np.asarray(sync["keyframe_map_poses"])
        kf = system.keyframe_trajectory()
        check(kf.shape == kf_sync.shape, f"async stored {len(kf)} keyframes, sync {len(kf_sync)}")
        kf_dev = float(np.max(np.abs(kf - kf_sync)))
        check(kf_dev < CPU_AGREE, f"async keyframe map poses {kf_dev:.3g} from the sync run's "
              f"(limit {CPU_AGREE})")
    per_frame = 2 * 4  # as in phase backend: what the frontend thread launches
    for name, k in (("knn", per_frame), ("knn_merge", per_frame), ("projector", per_frame // 2)):
        check(launches.get(name, 0) > k * n,  # the rest came from the worker thread
              f"{name}: {launches.get(name, 0)} launches on the async path, the frontend's "
              f"frames alone make {k * n}: the worker thread launched none")
    stats = backend.timer.stats()
    out = {**frame_stats(times, [r.is_keyframe for r in results]),
           "ate_map_m": ate, "ate_odom_m": ate_stats(odom, gt).rmse,
           "odom_vs_sync_max_abs": odom_dev, "keyframes_vs_sync_max_abs": kf_dev,
           "corrections_checked": upto, "correction_vs_sync_max_abs": max(corr_dev),
           "correction_lag_frames": lag, "loop_edges": loop_edges, "final_mode": backend.mode.name,
           "keyframes_stored": int(db.n_keyframes), "dropped": ab.dropped,
           "coalesced": ab.coalesced, "backlog_peak": int(max(backlog)), "flush_ms": flush_ms,
           "solver_runs": dict(backend.solver_runs), "solves": backend.solve_log,
           "stage_ms": stats, "knn_launches": launches["knn"],
           "knn_merge_launches": launches["knn_merge"], "projector_launches": launches["projector"]}
    ab.close()
    log("async", f"{n} frames, policy coalesce: {db.n_keyframes} keyframes stored, dropped 0, "
        f"coalesced {ab.coalesced}, peak backlog {out['backlog_peak']}, final flush "
        f"{flush_ms:.1f} ms; loop edges {loop_edges}, mode {backend.mode.name}; ATE map frame "
        f"{ate:.4f} m (sync {sync['ate_map_m']:.4f} m, odometry {out['ate_odom_m']:.4f} m)")
    log("async", f"against the sync run: odometry max |Δ| {odom_dev:.3g}; keyframe map poses "
        f"after the flush max |Δ| {kf_dev if kf_dev is None else format(kf_dev, '.3g')}; each of "
        f"the first {upto} frames' correction within {max(corr_dev):.3g} of one the sync run had "
        f"published, at most {max(lag)} frames before (median {float(np.median(lag)):g}; "
        f"frames after the loop closure {lag[sync['first_loop_frame']:][:12]})")
    log("async", "ms/frame sync | async: median "
        f"{sync['frame_ms_median']:.2f} | {out['frame_ms_median']:.2f}, p90 "
        f"{sync['frame_ms_p90']:.2f} | {out['frame_ms_p90']:.2f}, max "
        f"{sync['frame_ms_max']:.1f} | {out['frame_ms_max']:.1f}; keyframe frames median "
        f"{sync['frame_ms_median_kf']:.2f} | {out['frame_ms_median_kf']:.2f}, max "
        f"{max(m for m, k in zip(sync['frame_ms_all'], sync['is_keyframe']) if k):.1f} | "
        f"{out['frame_ms_max_kf']:.1f}")
    log("async", "GN iterations a solve: " + ", ".join(
        f"{s_['kind']}@{s_['keyframes']}:{s_['iterations']}" for s_ in backend.solve_log))
    log("async", "stage ms on the worker (n, mean, median, max): " + stage_line(stats))
    return out


# ---------------------------------------------------------------------------
# phases 8-10: the lifelong deployment on the city course
# ---------------------------------------------------------------------------


def city_config(extras=True):
    """The city run's configuration at HDL-64 width: with ``extras`` the
    dynamic-object defence and the occupancy grid of the first session;
    everything else as published, the submap Schur solve of full solves from
    192 keyframes included (``scripts/evaluate.py:158-159``)."""
    from lmsf_slam_tpu_torch.backend import LifelongConfig, LoopConfig
    from lmsf_slam_tpu_torch.datasets import HDL64
    from lmsf_slam_tpu_torch.mapping import OccupancyConfig
    from lmsf_slam_tpu_torch.ops.registration import RegistrationParams
    from lmsf_slam_tpu_torch.system import FeatureParams, SystemConfig

    extras_kw, trim_kw = {}, {}
    if extras:
        trim_kw = dict(trim_rel=3.0)
        extras_kw = dict(dynamic_carve_knn=3, dynamic_gate_unsupported=True,
                         occupancy=OccupancyConfig(size=1536, resolution=0.25))
    return SystemConfig(
        feature=FeatureParams(
            rings=HDL64["rings"], width=HDL64["width"], sectors=6, edges_per_sector=4,
            surfs_per_sector=8, range_noise=0.01, exclude_ground_edges=True,
            one_sided_occlusion=True),
        registration=RegistrationParams(max_iters=8, max_corr_dist=2.0, degen_rel=0.01, **trim_kw),
        map_update_trans=0.5,
        keyframe_trans=2.0,
        async_backend=True,
        dynamic_probation=extras,
        lifelong=LifelongConfig(
            optimize_window=100,
            schur_submaps=16,
            schur_min_vertices=192,
            localization_params=RegistrationParams(max_iters=8, max_corr_dist=2.0, degen_rel=0.01),
            **extras_kw),
        loop=LoopConfig(  # the loop detector's score gates, unrelaxed (0.05)
            min_frame_interval=30, exclude_recent=15, detect_spacing=2, search_radius=8.0,
            adjacent_window=4),
    )


class CityCourse:
    """The city world, its course and its movers, from one seed; scans are
    rendered on the card, one a call."""

    def __init__(self, seed=CITY_SEED):
        from lmsf_slam_tpu_torch.datasets import (
            make_city_course, make_city_world, make_movers)

        rng = np.random.default_rng(seed)
        self.world = make_city_world(int(rng.integers(2**31 - 1)))
        self.movers = make_movers(int(rng.integers(2**31 - 1)))
        self.traj = make_city_course()
        self.rng = rng

    def scan(self, frame, movers=True):
        from lmsf_slam_tpu_torch.datasets import HDL64, simulate_scan, world_with_movers

        w = world_with_movers(self.world, self.movers, frame) if movers else self.world
        return simulate_scan(w, self.traj[frame], self.rng, rings=HDL64["rings"],
                             width=HDL64["width"], elev_min=HDL64["elev_min"],
                             elev_max=HDL64["elev_max"], max_range=80.0, min_range=2.5,
                             noise=0.01, device="cuda")

    def sweep(self, frame):
        """The motion-blurred HDL-64 sweep that ends at ``frame`` (the static
        scan at frame 0), without movers, rendered on the card."""
        from lmsf_slam_tpu_torch.datasets import HDL64, simulate_scan, simulate_scan_moving

        kw = dict(rings=HDL64["rings"], width=HDL64["width"], elev_min=HDL64["elev_min"],
                  elev_max=HDL64["elev_max"], max_range=80.0, min_range=2.5, noise=0.01,
                  device="cuda")
        if frame == 0:
            return simulate_scan(self.world, self.traj[0], self.rng, **kw)
        return simulate_scan_moving(self.world, self.traj[frame - 1], self.traj[frame], self.rng,
                                    **kw)

    def gt_in_first_map_frame(self, frames):
        """Ground truth of ``frames`` in the map frame of a session that
        started at frame 0 (its origin is the first pose of the course)."""
        from lmsf_slam_tpu_torch.common import se3np

        return np.stack([se3np.pose_between(self.traj[0], self.traj[i]) for i in frames])


def drive_city(system, course, frames, movers, stamp0=0.0, keep=None):
    """Render and feed ``frames``; returns (results, seconds a frame in
    ``process``, backlog after every frame). ``keep``: (list, count), the
    first ``count`` scans are appended to the list."""
    results, times, backlog = [], [], []
    for i in frames:
        scan = course.scan(i, movers=movers)
        if keep is not None and len(keep[0]) < keep[1]:
            keep[0].append(scan)
        t0 = time.perf_counter()
        results.append(system.process(scan, stamp0 + 0.1 * i))
        times.append(time.perf_counter() - t0)
        backlog.append(system._async.backlog if system._async is not None else 0)
    return results, times, backlog


def repeat_check(scans, odom_first):
    """Run to run the card must repeat. ``voxel_downsample`` adds with
    atomics, in no fixed order: the same cloud five times over must give the
    same bits. And the kept first frames of the city course through a second
    system must give the first run's odometry poses bit for bit (a last-bit
    difference there grows to decimetres over the course)."""
    import torch

    from lmsf_slam_tpu_torch.ops.voxel import voxel_downsample
    from lmsf_slam_tpu_torch.system import MultiLidarSystem

    cells = 0
    for size, cap in ((0.4, 16384), (0.2, 65536)):
        first = voxel_downsample(scans[0], size, cap)
        cells = max(cells, int(first.mask.sum()))
        for _ in range(4):
            again = voxel_downsample(scans[0], size, cap)
            check(torch.equal(again.mask, first.mask) and torch.equal(again.xyz, first.xyz)
                  and torch.equal(again.attr, first.attr),
                  f"voxel_downsample at {size} m does not repeat bit for bit on the card")
    system = MultiLidarSystem(city_config(), device="cuda")
    odom = np.stack([system.process(scan, 0.1 * i).odom_pose for i, scan in enumerate(scans)])
    system.flush()
    system._async.close()
    same = np.array_equal(odom, odom_first)
    worst = float(np.abs(odom - odom_first).max())
    log("city", f"repeat: voxel_downsample of one scan ({cells} cells at most) bit-equal over 5 "
        f"calls; odometry of the first {len(scans)} frames in a second system "
        f"{'bit-equal' if same else 'differs'} (max |Δ| {worst:.3g})")
    check(same, f"the first {len(scans)} city frames do not repeat bit for bit: max |Δ| {worst:.3g}")
    return {"frames": len(scans), "voxel_cells": cells, "odom_max_abs_diff": worst}


def phase_city(course):
    import torch

    from lmsf_slam_tpu_torch import _build
    from lmsf_slam_tpu_torch.backend import KeyframeDatabase, LifelongBackend, WorkMode
    from lmsf_slam_tpu_torch.evaluation import ate_stats
    from lmsf_slam_tpu_torch.system import MultiLidarSystem

    cfg = city_config()
    f = cfg.feature
    check((f.edge_capacity, f.surf_capacity) == (1536, 3072), "city feature widths")
    payload = os.path.join(TMP, "city_payload")
    db = KeyframeDatabase(edge_capacity=f.edge_capacity, surf_capacity=f.surf_capacity,
                          storage_dir=payload, device="cuda")
    check(isinstance(db.edge_xyz, np.memmap), "the city database's payload is not disk-backed")
    carved = {"points": 0, "rows": set()}
    carve = db.carve

    def counting_carve(i, edge_keep, surf_keep):
        before = int(db.edge_mask[i].sum()) + int(db.surf_mask[i].sum())
        carve(i, edge_keep, surf_keep)
        removed = before - int(db.edge_mask[i].sum()) - int(db.surf_mask[i].sum())
        if removed:
            carved["points"] += removed
            carved["rows"].add(int(i))

    db.carve = counting_carve
    backend = LifelongBackend(db=db, config=cfg.lifelong, loop_config=cfg.loop)
    system = MultiLidarSystem(cfg, backend=backend, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    frames = range(CITY_FRAMES)
    t0 = time.perf_counter()
    kept = []
    results, times, backlog = drive_city(system, course, frames, movers=True,
                                         keep=(kept, CITY_REPEAT_FRAMES))
    t1 = time.perf_counter()
    system.flush()
    flush_ms = (time.perf_counter() - t1) * 1e3
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    ab = system._async

    est = system.trajectory()
    loops = [h for h in backend.history if h.loop_closed]
    runs = dict(backend.solver_runs)
    m = db._mirror_sync()
    rows = sorted(carved["rows"])
    grid = system.occupancy_grid()
    oc = cfg.lifelong.occupancy
    n_occ, n_free = int((grid > 0).sum()), int((grid < 0).sum())
    gt = course.gt_in_first_map_frame(frames)
    odom = np.stack([r.odom_pose for r in results])
    finite = bool(np.isfinite(est).all() and np.isfinite(odom).all())
    ate_map = ate_stats(est, gt).rmse if finite else float("nan")
    ate_odom = ate_stats(odom, gt).rmse if finite else float("nan")
    n_kf_frames = sum(r.is_keyframe for r in results)
    # frames that came out with a correction the worker had published by then
    # (the trajectory is the frames' own map poses, nothing is recomposed
    # after the flush)
    shift = np.linalg.norm(est[:, 4:] - odom[:, 4:], axis=1) if finite else np.zeros(0)
    corrected = np.nonzero(shift > CITY_CORRECTION_M)[0]
    stats = backend.timer.stats()
    eij, eloop = db.eij[:db.n_edges], db.eloop[:db.n_edges]
    out = {
        **frame_stats(times, [r.is_keyframe for r in results]),
        "frames": CITY_FRAMES, "wall_s": wall, "flush_ms": flush_ms,
        "keyframe_frames": int(n_kf_frames), "keyframes_stored": int(db.n_keyframes),
        "edges": int(db.n_edges), "loops_closed": len(loops), "loop_edges": eij[eloop].tolist(),
        "modes": sorted({h.mode.name for h in backend.history}), "final_mode": backend.mode.name,
        "history": [(h.mode.name, h.keyframe_id, bool(h.loop_closed), float(h.score),
                     float(h.overlap)) for h in backend.history],
        "solver_runs": runs, "solves": backend.solve_log,
        "ate_map_m": ate_map, "ate_odom_m": ate_odom, "dropped": ab.dropped,
        "corrected_frames": int(corrected.size),
        "first_corrected_frame": int(corrected[0]) if corrected.size else None,
        "correction_max_m": float(shift.max()) if shift.size else None,
        "odom_poses": odom.tolist(), "map_poses": est.tolist(),
        "num_matches": [r.num_matches for r in results],
        "converged": [r.converged for r in results],
        "coalesced": ab.coalesced, "backlog_peak": int(max(backlog)), "backlog": backlog,
        "carved_points": carved["points"], "carved_rows": len(rows),
        "grid_occupied": n_occ, "grid_free": n_free,
        "grid_bytes": int(grid.numel() * grid.element_size()),
        "mirror_bytes": mirror_nbytes(db), "mirror_rows": int(db._mirror["cap"]),
        "payload_bytes": int(sum(os.path.getsize(os.path.join(payload, n)) for n in
                                 os.listdir(payload))),
        "peak_device_bytes": int(peak), "stage_ms": stats,
        "knn_launches": launches["knn"], "knn_merge_launches": launches["knn_merge"],
        "projector_launches": launches.get("projector", 0),
        "knn_launches_per_frame": CITY_KNN_PER_FRAME,
        "knn_launches_per_backend_keyframe":
            (launches["knn"] - CITY_KNN_PER_FRAME * CITY_FRAMES) / max(n_kf_frames, 1),
    }
    log("city", f"{CITY_FRAMES} frames in {wall:.1f} s ({n_kf_frames} through the gate; final flush "
        f"{flush_ms:.0f} ms): {db.n_keyframes} keyframes and {db.n_edges} edges stored, loops "
        f"closed {len(loops)} (edges {out['loop_edges']}), modes seen {out['modes']}, final "
        f"{backend.mode.name}; solver runs {runs}")
    log("city", f"ATE map frame {ate_map:.4f} m, odometry alone {ate_odom:.4f} m (limit "
        f"{CITY_ATE_LIMIT}); {corrected.size} frames came out more than {CITY_CORRECTION_M} m from "
        f"their odometry pose, the first at frame {out['first_corrected_frame']}, the most "
        f"{out['correction_max_m']:.3f} m; dropped {ab.dropped}, coalesced {ab.coalesced}, peak backlog "
        f"{out['backlog_peak']}; carved {carved['points']} points in {len(rows)} keyframes, mirror "
        f"masks equal to the host's; grid {n_occ} occupied and {n_free} free cells, "
        f"{out['grid_bytes'] / 2**20:.2f} MiB")
    log("city", f"ms/frame median {out['frame_ms_median']:.2f}, p90 {out['frame_ms_p90']:.2f}, max "
        f"{out['frame_ms_max_after_first']:.1f} (the first frame, which also initialises the "
        f"libraries, {out['frame_ms_first']:.1f}); frames without a keyframe median "
        f"{out['frame_ms_median_no_kf']:.2f}; keyframe frames median "
        f"{out['frame_ms_median_kf']:.2f}, max {out['frame_ms_max_kf']:.1f}")
    log("city", "stage ms on the worker (n, mean, median, max): " + stage_line(stats))
    log("city", "GN iterations a solve: " + ", ".join(
        f"{s_['kind']}@{s_['keyframes']}:{s_['iterations']}" for s_ in backend.solve_log))
    log("city", f"knn launches {launches['knn']} (+{launches['knn_merge']} merges): "
        f"{CITY_KNN_PER_FRAME} a frame and {out['knn_launches_per_backend_keyframe']:.1f} more a "
        f"keyframe frame; mirror {out['mirror_bytes'] / 2**20:.2f} MiB in {out['mirror_rows']} "
        f"rows; payload on disk {out['payload_bytes'] / 2**20:.2f} MiB; peak device memory "
        f"{peak / 2**20:.1f} MiB")
    check(len(results) == CITY_FRAMES and finite, "non-finite pose on the city course")
    check(np.isfinite(db.map_poses[:db.n_keyframes]).all(), "non-finite keyframe pose")
    check(len(loops) >= 1, "no loop closed on the city course at the 0.05 gates")
    check(runs["windowed"] >= 1, f"no windowed solve ran: {runs}")
    check(any(h.mode is WorkMode.LOCALIZATION for h in backend.history), "LOCALIZATION never reached")
    check(ab.dropped == 0, f"{ab.dropped} keyframes dropped")
    check(carved["points"] > 0, "no stored point was carved")
    check(bool((m["emk"][rows].cpu().numpy() == db.edge_mask[rows]).all())
          and bool((m["smk"][rows].cpu().numpy() == db.surf_mask[rows]).all()),
          "a carved row's mirror masks differ from the host's")
    check(n_occ > 0 and n_free > 0, f"occupancy grid: {n_occ} occupied and {n_free} free cells")
    check(float(grid.min()) >= oc.l_min and float(grid.max()) <= oc.l_max and bool(
        torch.isfinite(grid).all()), "occupancy grid outside its clip")
    check(ate_map < CITY_ATE_LIMIT, f"city map-frame ATE {ate_map:.4f} m ≥ {CITY_ATE_LIMIT} m")
    # the frame whose keyframe closed the first loop, from its stamp (0.1 s a frame)
    first_loop = int(round(float(db.stamps[loops[0].keyframe_id]) / 0.1))
    check(corrected.size > 0 and corrected[-1] > first_loop,
          "no frame after the loop closure came out with a corrected map pose: the worker's "
          "correction never reached a FrameResult")
    check(ate_map < ate_odom, f"city map-frame ATE {ate_map:.4f} m is no better than odometry's "
          f"{ate_odom:.4f} m")
    out["repeat"] = repeat_check(kept, odom[:CITY_REPEAT_FRAMES])
    for name in ("knn", "knn_merge"):
        check(launches.get(name, 0) > CITY_KNN_PER_FRAME * CITY_FRAMES,
              f"{name}: {launches.get(name, 0)} launches on the city path, the frames alone make "
              f"{CITY_KNN_PER_FRAME * CITY_FRAMES}")
    check(out["projector_launches"] > 4 * CITY_FRAMES,  # 4 associations a frame
          f"projector: {out['projector_launches']} launches on the city path, the frames alone "
          f"make {4 * CITY_FRAMES}")
    return out, {"system": system}


def file_digests(paths):
    out = {}
    for p in paths:
        with open(p, "rb") as fh:
            out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def phase_persist(course, holder):
    """Save the city run, drop it, boot a new system from the files.
    ``holder["system"]`` is the city run's system, taken out here so that
    nothing keeps it alive."""
    import torch

    from lmsf_slam_tpu_torch import _build
    from lmsf_slam_tpu_torch.backend import KeyframeDatabase, WorkMode
    from lmsf_slam_tpu_torch.backend.keyframe_db import _DISK_FIELDS
    from lmsf_slam_tpu_torch.interop import (
        KEYFRAME_DB_EDGE_FIELDS, KEYFRAME_DB_FIELDS, keyframe_db_from_numpy)
    from lmsf_slam_tpu_torch.mapping import occupancy_from_database
    from lmsf_slam_tpu_torch.system import MultiLidarSystem

    system = holder.pop("system")
    path = os.path.join(TMP, "city_db.npz")
    db = system.backend.db
    n_kf, n_edges = db.n_keyframes, db.n_edges
    t0 = time.perf_counter()
    system.save(path)
    save_ms = (time.perf_counter() - t0) * 1e3
    payload = db.storage_dir
    files = [path] + [os.path.join(payload, name + ".dat") for name in _DISK_FIELDS]
    before = file_digests(files)

    # a RAM-mode save → load round trip of the same database
    fields = {k: np.array(getattr(db, k)[:n_kf]) for k in KEYFRAME_DB_FIELDS}
    fields.update({k: getattr(db, k)[:n_edges] for k in KEYFRAME_DB_EDGE_FIELDS})
    fields.update(n_keyframes=n_kf, n_edges=n_edges)
    ram_path = os.path.join(TMP, "city_db_ram.npz")
    t0 = time.perf_counter()
    keyframe_db_from_numpy(fields, device="cuda").save(ram_path)
    ram_save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ram = KeyframeDatabase.load(ram_path, device="cuda")
    ram_load_ms = (time.perf_counter() - t0) * 1e3
    check(ram.storage_dir is None and (ram.n_keyframes, ram.n_edges) == (n_kf, n_edges),
          "RAM round trip: counts differ")
    for k in KEYFRAME_DB_FIELDS:
        check(np.array_equal(getattr(ram, k)[:n_kf], fields[k]), f"RAM round trip: {k} differs")
    for k in KEYFRAME_DB_EDGE_FIELDS:
        check(np.array_equal(getattr(ram, k)[:n_edges], fields[k]), f"RAM round trip: {k} differs")
    del ram, fields

    system._async.close()
    del system, db
    cfg = city_config(extras=False)
    cfg = cfg._replace(lifelong=cfg.lifelong._replace(occupancy=city_config().lifelong.occupancy))
    t0 = time.perf_counter()
    booted = MultiLidarSystem.load(path, cfg, device="cuda")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    backend = booted.backend
    check(backend.db.device.type == "cuda", f"the loaded database is on {backend.db.device}")
    check(backend.mode is WorkMode.RELOCALIZATION, "a loaded system must boot in RELOCALIZATION")
    check(backend.db.n_keyframes == n_kf and backend.db.n_edges == n_edges, "loaded counts differ")
    check(os.path.abspath(backend.db.storage_dir) != os.path.abspath(payload),
          "the session writes into the checkpoint's payload")
    grid = booted.occupancy_grid()
    check(grid is not None and int((grid > 0).sum()) > 0 and int((grid < 0).sum()) > 0,
          "the booted grid was not rebuilt from the database")
    t0 = time.perf_counter()
    rebuilt = occupancy_from_database(backend.db, cfg.lifelong.occupancy)
    torch.cuda.synchronize()
    rebuild_ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.equal(grid, rebuilt)), "the booted grid is not occupancy_from_database's")

    frames = range(CITY_REBOOT_START, CITY_REBOOT_START + CITY_REBOOT_FRAMES)
    _build.reset_launches()
    results, times, _ = drive_city(booted, course, frames, movers=False, stamp0=1000.0)
    booted.flush()
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for name in ("knn", "knn_merge", "projector"):
        check(launches.get(name, 0) > 0, f"{name} was not launched on the reboot path")
    localized = [k for k, r in enumerate(results) if r.mode is not WorkMode.RELOCALIZATION]
    check(bool(localized), "the system booted from disk never relocalized")
    kf_before = sum(r.is_keyframe for r in results[:localized[0] + 1])
    check(kf_before <= REBOOT_KEYFRAMES,
          f"relocalized only after {kf_before} keyframes (limit {REBOOT_KEYFRAMES})")
    gt = course.gt_in_first_map_frame(frames)
    est = np.stack([r.map_pose for r in results])
    check(np.isfinite(est).all(), "non-finite pose after the reboot from disk")
    err = np.linalg.norm(est[localized[0]:, 4:] - gt[localized[0]:, 4:], axis=1)
    check(float(err.max()) < REBOOT_LIMIT,
          f"after relocalizing, the map position lies {err.max():.3f} m from the ground truth in "
          f"the first session's map frame (limit {REBOOT_LIMIT})")
    for name in _DISK_FIELDS:  # the session's own copy, flushed
        getattr(backend.db, name).flush()
    check(file_digests(files) == before, "the reboot session changed the checkpoint's files")
    stats = backend.timer.stats()
    out = {
        "save_ms": save_ms, "load_ms": load_ms, "npz_bytes": os.path.getsize(path),
        "payload_bytes": int(sum(os.path.getsize(p) for p in files[1:])),
        "ram_npz_bytes": os.path.getsize(ram_path), "ram_save_ms": ram_save_ms,
        "ram_load_ms": ram_load_ms, "grid_rebuild_ms": rebuild_ms, "keyframes": int(n_kf),
        "start_frame": CITY_REBOOT_START, "frames": len(results),
        "relocalized_at_frame": CITY_REBOOT_START + localized[0],
        "keyframes_until_relocalized": int(kf_before),
        "map_err_rmse_m": float(np.sqrt(np.mean(err ** 2))), "map_err_max_m": float(err.max()),
        "final_mode": results[-1].mode.name, "history": [
            (h.mode.name, h.keyframe_id, float(h.score), float(h.overlap)) for h in backend.history],
        "coalesced": booted._async.coalesced, "dropped": booted._async.dropped,
        **frame_stats(times, [r.is_keyframe for r in results]), "stage_ms": stats,
        "knn_launches": launches["knn"], "knn_merge_launches": launches["knn_merge"],
        "projector_launches": launches["projector"],
    }
    booted._async.close()
    log("persist", f"save of {n_kf} keyframes (memmap payload {out['payload_bytes'] / 2**20:.2f} "
        f"MiB flushed, npz {out['npz_bytes']} bytes) {save_ms:.1f} ms; load onto the card (payload "
        f"copied into a session directory, grid rebuilt) {load_ms:.1f} ms, of which the grid "
        f"rebuild from {n_kf} keyframes {rebuild_ms:.1f} ms; RAM mode: npz "
        f"{out['ram_npz_bytes']} bytes, save {ram_save_ms:.1f} ms, load {ram_load_ms:.1f} ms, "
        "arrays equal")
    log("persist", f"booted in RELOCALIZATION; fed frames {CITY_REBOOT_START}.."
        f"{CITY_REBOOT_START + len(results) - 1} without cars: relocalized at frame "
        f"{out['relocalized_at_frame']} after {kf_before} keyframe(s); map position vs ground "
        f"truth in the first session's map frame rmse {out['map_err_rmse_m']:.3f} m, max "
        f"{out['map_err_max_m']:.3f} m (limit {REBOOT_LIMIT}); final mode {out['final_mode']}; "
        f"coalesced {out['coalesced']}; ms/frame median {out['frame_ms_median']:.2f}, max "
        f"{out['frame_ms_max']:.1f}; the checkpoint's {len(files)} files are unchanged")
    log("persist", "stage ms on the worker (n, mean, median, max): " + stage_line(stats))
    return out, path


def phase_merge(course, path):
    """A second session over a stretch the first one drove, aligned to the
    first session's checkpoint by appearance and merged into it."""
    import torch

    from lmsf_slam_tpu_torch import _build
    from lmsf_slam_tpu_torch.backend import (
        KeyframeDatabase, LifelongBackend, align_sessions, merge_sessions)
    from lmsf_slam_tpu_torch.common import se3np
    from lmsf_slam_tpu_torch.system import MultiLidarSystem

    cfg = city_config(extras=False)
    session_b = MultiLidarSystem(cfg, device="cuda")
    frames = range(MERGE_START, MERGE_START + MERGE_FRAMES)
    _, times, _ = drive_city(session_b, course, frames, movers=False, stamp0=2000.0)
    session_b.flush()
    session_b._async.close()
    db_b = session_b.backend.db
    db_a = KeyframeDatabase.load(path, storage_dir=os.path.join(TMP, "merge_session"),
                                 device="cuda")
    n_a, e_a, n_b, e_b = db_a.n_keyframes, db_a.n_edges, db_b.n_keyframes, db_b.n_edges
    check(n_b >= 20, f"the second session stored only {n_b} keyframes")
    _build.reset_launches()
    t0 = time.perf_counter()
    res = align_sessions(db_a, db_b, cfg.loop)
    align_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    check(res is not None, "no alignment between the sessions")
    check(len(res.matches) >= 3, f"only {len(res.matches)} consistent matches")
    for name in ("knn", "knn_merge", "projector"):
        check(launches.get(name, 0) > 0, f"{name} was not launched by align_sessions")
    # session B's map frame starts at the course pose MERGE_START
    truth = se3np.pose_between(course.traj[0], course.traj[MERGE_START])
    d = se3np.pose_between(truth, res.transform)
    err_m = float(np.linalg.norm(se3np.pose_trans(d)))
    err_deg = float(np.degrees(np.linalg.norm(se3np.so3_log(se3np.pose_quat(d)))))
    check(err_m < MERGE_LIMIT_M and err_deg < MERGE_LIMIT_DEG,
          f"the recovered transform is {err_m:.3f} m / {err_deg:.3f}° from the truth (limits "
          f"{MERGE_LIMIT_M} m / {MERGE_LIMIT_DEG}°)")
    t0 = time.perf_counter()
    offset = merge_sessions(db_a, db_b, res)
    merge_s = time.perf_counter() - t0
    check(offset == n_a and db_a.n_keyframes == n_a + n_b, "keyframe counts do not add up")
    check(db_a.n_edges == e_a + e_b + len(res.matches), "edge counts do not add up")
    inter = slice(e_a + e_b, db_a.n_edges)
    check(bool(db_a.eloop[inter].all()) and bool((db_a.eij[inter, 0] < n_a).all())
          and bool((db_a.eij[inter, 1] >= n_a).all()),
          "inter-session edges are not loop edges from the first session to the second")
    merged = LifelongBackend(db=db_a, config=cfg.lifelong, loop_config=cfg.loop)
    t0 = time.perf_counter()
    stats = merged.force_global_optimize()
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    poses = db_a.map_poses[:db_a.n_keyframes]
    check(stats is not None and np.isfinite(poses).all(), "the merged solve is not finite")
    gt_b = course.gt_in_first_map_frame(
        [int(round((db_b.stamps[i] - 2000.0) / 0.1)) for i in range(n_b)])
    err_b = np.linalg.norm(poses[n_a:, 4:] - gt_b[:, 4:], axis=1)
    solve = merged.solve_log[-1]
    out = {"session_b_keyframes": int(n_b), "session_b_edges": int(e_b),
           "session_b_frame_ms_median": float(np.median(np.asarray(times) * 1e3)),
           "queries": res.n_tried, "matches": [(int(a), int(b)) for a, b, _ in res.matches],
           "align_s": align_s, "merge_s": merge_s, "transform": res.transform.tolist(),
           "transform_err_m": err_m, "transform_err_deg": err_deg,
           "merged_keyframes": int(db_a.n_keyframes), "merged_edges": int(db_a.n_edges),
           "solve_ms": solve_ms, "solve": solve,
           "merged_b_err_rmse_m": float(np.sqrt(np.mean(err_b ** 2))),
           "merged_b_err_max_m": float(err_b.max()),
           "knn_launches": launches.get("knn", 0), "knn_merge_launches": launches.get("knn_merge", 0),
           "projector_launches": launches.get("projector", 0)}
    log("merge", f"second session: frames {MERGE_START}..{MERGE_START + MERGE_FRAMES - 1}, {n_b} "
        f"keyframes; align_sessions {res.n_tried} queries in {align_s:.1f} s → "
        f"{len(res.matches)} consistent matches, transform {err_m:.3f} m / {err_deg:.3f}° from "
        f"the truth (limits {MERGE_LIMIT_M} m / {MERGE_LIMIT_DEG}°); merged graph "
        f"{db_a.n_keyframes} keyframes ({n_a} + {n_b}) and {db_a.n_edges} edges ({e_a} + {e_b} + "
        f"{len(res.matches)} inter-session loop edges) in {merge_s:.2f} s; full solve "
        f"{solve_ms:.0f} ms, {solve['iterations']} GN iterations, chi2 "
        f"{solve['chi2_initial']:.4g} → {solve['chi2_final']:.4g}; the second session's keyframes "
        f"then lie rmse {out['merged_b_err_rmse_m']:.3f} m, max {out['merged_b_err_max_m']:.3f} m "
        "from the ground truth in the first session's map frame")
    return out


# ---------------------------------------------------------------------------
# phase 11: the IMU-aided system on the city course
# ---------------------------------------------------------------------------


def lio_config():
    """``scripts/evaluate.py::run_city --imu --sync`` at HDL-64 width: the
    city configuration without the dynamic-object extras, the IMU-aided
    front end, the backend inline."""
    return city_config(extras=False)._replace(use_imu=True, async_backend=False)


def course_velocity(course):
    """The course's velocity at frame 0 in the odometry frame (anchored at
    the first pose), as ``scripts/evaluate.py`` seeds the filter."""
    from lmsf_slam_tpu_torch.common import se3np

    traj = course.traj.astype(np.float64)
    va = se3np.quat_rotate(se3np.quat_conj(traj[0, :4]), (traj[1, 4:7] - traj[0, 4:7]) * 10.0)
    return va.astype(np.float32)


def lio_system(device, course):
    """A fresh IMU-aided system whose filter starts with the course velocity."""
    import torch

    from lmsf_slam_tpu_torch.system import MultiLidarSystem

    system = MultiLidarSystem(lio_config(), device=device)
    system._lio.eskf = system._lio.eskf._replace(
        v=torch.as_tensor(course_velocity(course), device=device))
    return system


def imu_args(windows, frame):
    return {} if frame == 0 else dict(zip(("gyro", "acc", "imu_dts"), windows[frame]))


def lio_graph_run(device, windows, priors, va):
    """``FactorGraphLio`` on ``device`` over IMU windows 1.. with the LIO poses
    of those frames as priors; the window anchored at frame 0's pose and the
    course velocity. Returns the (pose, velocity) after each window, the chi2
    of each solve and the solve times (ms, host clock, ending in the
    wrapper's read-back)."""
    import torch

    from lmsf_slam_tpu_torch.backend.lio_graph import FactorGraphLio
    from lmsf_slam_tpu_torch.estimator import preintegrate

    fg = FactorGraphLio(device=device)
    fg.poses[0] = priors[0]
    fg.vels[0] = va
    fg.priors = [(0, priors[0].copy())]
    out, chi2, ms = [], [], []
    for k in range(1, len(priors)):
        gy, ac, dts = (torch.as_tensor(a, device=device) for a in windows[k])
        zero = torch.zeros(3, device=device)
        t0 = time.perf_counter()
        pre = preintegrate(gy, ac, dts, torch.ones(len(dts), dtype=torch.bool, device=device),
                           zero, zero)
        pose, vel = fg.add_scan(pre, priors[k])
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(np.concatenate([pose, vel]))
        chi2.append((float(fg.last_stats.chi2_initial), float(fg.last_stats.chi2_final)))
    return np.stack(out), chi2, ms, fg.resets


def phase_lio(fused_profile):
    """The IMU-aided system over the first frames of the city course, then
    the LIO factor graph over its IMU windows (``fused_profile``: phase
    profile's numbers, printed beside this path's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lmsf_slam_tpu_torch import _build
    from lmsf_slam_tpu_torch.datasets import make_city_imu
    from lmsf_slam_tpu_torch.evaluation import ate_stats

    course = CityCourse()
    windows = make_city_imu(course.traj)  # 100 Hz, seed 7, the whole course as the reference
    system = lio_system("cuda", course)
    lio = system._lio
    propagate, spans = lio._propagate, []

    def timed_propagate(*args, **kw):  # device span (CUDA events) and host ms, no wait
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        state = propagate(*args, **kw)
        host = (time.perf_counter() - t0) * 1e3
        end.record()
        spans.append((start, end, host))
        return state

    lio._propagate = timed_propagate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    results, times, kept, profiled = [], [], [], []
    t_run = time.perf_counter()
    for i in range(LIO_FRAMES):
        scan = course.sweep(i)
        if len(kept) < max(LIO_CPU_FRAMES, 10):
            kept.append(scan)
        if i in LIO_PROFILE_FRAMES:  # one frame a trace, left out of the frame times
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                res = system.process(scan, 0.1 * i, **imu_args(windows, i))
                torch.cuda.synchronize()
            profiled.append((res.is_keyframe, profile_counts(prof, 1)))
        else:
            t0 = time.perf_counter()
            res = system.process(scan, 0.1 * i, **imu_args(windows, i))
            times.append(time.perf_counter() - t0)
        results.append(res)
    wall = time.perf_counter() - t_run
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    lio._propagate = propagate
    prop_dev = [s.elapsed_time(e) for s, e, _ in spans]
    prop_host = [h for _, _, h in spans]
    backend, db = system.backend, system.backend.db

    est = system.trajectory()
    odom = np.stack([r.odom_pose for r in results])
    finite = bool(np.isfinite(est).all() and np.isfinite(odom).all())
    gt = course.gt_in_first_map_frame(range(LIO_FRAMES))
    ate_map = ate_stats(est, gt).rmse if finite else float("nan")
    ate_odom = ate_stats(odom, gt).rmse if finite else float("nan")
    loops = [h for h in backend.history if h.loop_closed]
    failures = lio.failures
    quiet = [c for kf, c in profiled if not kf]  # profiled frames without a keyframe
    stats = backend.timer.stats()
    n_kf_frames = sum(r.is_keyframe for r in results)
    is_kf = [r.is_keyframe for i, r in enumerate(results) if i not in LIO_PROFILE_FRAMES]

    # the filter's own work on one window (propagation, failure gate, pose
    # correction, the masked selects), traced alone: it must read nothing back
    from lmsf_slam_tpu_torch.estimator.eskf import _select, eskf_update_pose

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state = lio._propagate(*windows[1])
        failed = lio._failed(state)
        state = _select(failed, state._replace(cov=lio._init_cov), state)
        corrected = eskf_update_pose(state, lio.prev_pose, lio.config.reg_pos_std,
                                     lio.config.reg_rot_std)
        _select(failed, state, corrected)
        torch.cuda.synchronize()
    filter_counts = profile_counts(prof, 1)

    # the same frames on the CPU (plain k-NN): the kept scans, the same windows
    cpu = lio_system("cpu", course)
    t0 = time.perf_counter()
    odom_cpu = np.stack([cpu.process(kept[i], 0.1 * i, **imu_args(windows, i)).odom_pose
                         for i in range(LIO_CPU_FRAMES)])  # process copies the scan over
    cpu_ms = (time.perf_counter() - t0) * 1e3 / LIO_CPU_FRAMES
    dev_cpu = float(np.max(np.abs(odom_cpu - odom[:LIO_CPU_FRAMES])))

    # a GNSS fix after frame 0 of a second run rides the next keyframe
    gnss = lio_system("cuda", course)
    gnss.process(kept[0], 0.0)
    gnss.process_gnss(np.asarray(LIO_GNSS_LLA))
    for i in range(1, len(kept)):
        gnss.process(kept[i], 0.1 * i, **imu_args(windows, i))
        if gnss.backend.db.n_keyframes >= 2:
            break
    gdb = gnss.backend.db
    gnss_ok = (gdb.n_keyframes >= 2 and bool(gdb.gnss_valid[1]) and not bool(gdb.gnss_valid[0])
               and float(np.linalg.norm(gdb.gnss_pos[1])) < 1e-3)

    # the LIO factor graph over the course's IMU windows, card and CPU
    priors = odom[:LIO_GRAPH_WINDOWS + 1].astype(np.float32)
    va = course_velocity(course)
    g_card, chi2_card, ms_card, resets = lio_graph_run("cuda", windows, priors, va)
    g_cpu, _, ms_cpu, _ = lio_graph_run("cpu", windows, priors, va)
    graph_dev = float(np.max(np.abs(g_card[:, :7] - g_cpu[:, :7])))

    ms = np.asarray(times) * 1e3
    out = {
        **frame_stats(times, is_kf),
        "frames": LIO_FRAMES, "wall_s": wall, "keyframe_frames": int(n_kf_frames),
        "keyframes_stored": int(db.n_keyframes), "edges": int(db.n_edges),
        "loops_closed": len(loops),
        "loop_edges": db.eij[:db.n_edges][db.eloop[:db.n_edges]].tolist(),
        "first_loop_keyframe": int(loops[0].keyframe_id) if loops else None,
        "modes": sorted({h.mode.name for h in backend.history}), "final_mode": backend.mode.name,
        "solver_runs": dict(backend.solver_runs), "solves": backend.solve_log,
        "ate_map_m": ate_map, "ate_odom_m": ate_odom, "eskf_failures": failures,
        "odom_poses": odom.tolist(), "map_poses": est.tolist(),
        "num_matches": [r.num_matches for r in results],
        "eskf_propagate_device_ms": prop_dev, "eskf_propagate_host_ms": prop_host,
        "eskf_propagate_device_ms_median": float(np.median(prop_dev)),
        "eskf_propagate_host_ms_median": float(np.median(prop_host)),
        "profiled": [{"is_keyframe": kf, **{k: v for k, v in c.items() if k != "rows"},
                      "top": c["rows"][:8]} for kf, c in profiled],
        "stage_ms": stats, "peak_device_bytes": int(peak),
        "knn_launches": launches.get("knn", 0), "knn_merge_launches": launches.get("knn_merge", 0),
        "projector_launches": launches.get("projector", 0),
        "cpu_frames": LIO_CPU_FRAMES, "cpu_max_abs_pose_diff": dev_cpu, "cpu_frame_ms": cpu_ms,
        "gnss_keyframes": int(gdb.n_keyframes), "gnss_prior": gdb.gnss_pos[1].tolist()
        if gdb.n_keyframes >= 2 else None,
        "graph_windows": LIO_GRAPH_WINDOWS, "graph_card_vs_cpu_m": graph_dev,
        "graph_chi2": chi2_card, "graph_resets": resets, "graph_ms_card": ms_card,
        "graph_ms_cpu": ms_cpu,
    }
    q = {k: float(np.mean([c[k] for c in quiet])) if quiet else float("nan")
         for k in ("device_events", "dtoh", "htod", "waits", "device_ms")}
    out["profiled_quiet_mean"] = q
    out["filter_alone"] = {k: v for k, v in filter_counts.items() if k != "rows"}
    fp = fused_profile
    log("lio", f"{LIO_FRAMES} frames in {wall:.1f} s ({n_kf_frames} through the gate): "
        f"{db.n_keyframes} keyframes and {db.n_edges} edges stored, loops closed {len(loops)} "
        f"(edges {out['loop_edges']}, the first at keyframe {out['first_loop_keyframe']}), modes "
        f"{out['modes']}, final {backend.mode.name}; solver runs {out['solver_runs']}; ESKF failure "
        f"resets {failures}")
    log("lio", f"ATE map frame {ate_map:.4f} m (limit {LIO_ATE_LIMIT}), odometry alone "
        f"{ate_odom:.4f} m; first {LIO_CPU_FRAMES} frames card vs CPU max |Δpose| {dev_cpu:.3g} "
        f"(CPU {cpu_ms:.0f} ms a frame); peak device memory {peak / 2**20:.1f} MiB")
    log("lio", f"ms/frame median {out['frame_ms_median']:.2f}, p90 {out['frame_ms_p90']:.2f}, max "
        f"{out['frame_ms_max_after_first']:.1f} (first {out['frame_ms_first']:.1f}); without a "
        f"keyframe median {out['frame_ms_median_no_kf']:.2f}; keyframe frames median "
        f"{out['frame_ms_median_kf']:.2f}, max {out['frame_ms_max_kf']:.1f}; ESKF propagation a "
        f"frame: device span median {out['eskf_propagate_device_ms_median']:.3f} ms, host "
        f"{out['eskf_propagate_host_ms_median']:.3f} ms")
    log("lio", f"a frame without a keyframe ({len(quiet)} profiled): {q['device_events']:.0f} device "
        f"events, {q['device_ms']:.3f} ms busy, device-to-host copies {q['dtoh']:g}, host-to-device "
        f"{q['htod']:g}, host waits {q['waits']:g}; the fused frame (phase profile): "
        f"{fp.get('device_events_per_frame')} events, {fp.get('dtoh_per_frame')} device-to-host, "
        f"{fp.get('htod_per_frame')} host-to-device, {fp.get('host_waits_per_frame')} waits; the "
        f"filter's work on one window alone: "
        f"{filter_counts['device_events']:.0f} device events, {filter_counts['device_ms']:.3f} ms "
        f"busy, device-to-host {filter_counts['dtoh']:g}, host-to-device {filter_counts['htod']:g}, "
        f"host waits {filter_counts['waits']:g}")
    log("lio", "stage ms (n, mean, median, max): " + stage_line(stats))
    log("lio", "GN iterations a solve: " + ", ".join(
        f"{s_['kind']}@{s_['keyframes']}:{s_['iterations']}" for s_ in backend.solve_log))
    log("lio", f"knn launches {out['knn_launches']} (+{out['knn_merge_launches']} merges): "
        f"{LIO_KNN_PER_FRAME} a frame and "
        f"{(out['knn_launches'] - LIO_KNN_PER_FRAME * LIO_FRAMES) / max(n_kf_frames, 1):.1f} more "
        "a keyframe frame")
    log("lio", f"GNSS: a fix after frame 0 of a second run, the next keyframe (of "
        f"{gdb.n_keyframes}) carries {out['gnss_prior']}")
    log("lio", f"FactorGraphLio over {LIO_GRAPH_WINDOWS} IMU windows ({resets} failure resets): "
        f"card vs CPU max |Δ| {graph_dev:.3g} (limit {LIO_GRAPH_AGREE}); a solve "
        f"{np.median(ms_card):.0f} ms on the card, {np.median(ms_cpu):.0f} ms on the CPU; chi2 "
        + ", ".join(f"{a:.3g}→{b:.3g}" for a, b in chi2_card[:5]) + " …")
    check(len(results) == LIO_FRAMES and finite, "non-finite pose on the LIO course")
    check(ate_map < LIO_ATE_LIMIT, f"LIO map-frame ATE {ate_map:.4f} m ≥ {LIO_ATE_LIMIT} m")
    check(len(loops) >= 1, "no loop closed on the LIO course")
    check(failures == 0, f"{failures} ESKF failure resets")
    for name, k in (("knn", LIO_KNN_PER_FRAME), ("knn_merge", LIO_KNN_PER_FRAME),
                    ("projector", LIO_KNN_PER_FRAME // 2)):
        check(launches.get(name, 0) > k * LIO_FRAMES,
              f"{name}: {launches.get(name, 0)} launches on the LIO path, its frames alone make "
              f"{k * LIO_FRAMES}")
    check(filter_counts["dtoh"] == 0,
          f"the filter's work read back {filter_counts['dtoh']:g} times, not none")
    check(bool(quiet) and all(c["dtoh"] == 1 for c in quiet),
          f"a LIO frame without a keyframe copied {[c['dtoh'] for c in quiet]} times from the "
          "card, not once (its read-back)")
    check(dev_cpu < CPU_AGREE, f"LIO card vs CPU poses differ by {dev_cpu:.3g} over "
          f"{LIO_CPU_FRAMES} frames (limit {CPU_AGREE})")
    check(gnss_ok, f"the keyframe after the GNSS fix carries {out['gnss_prior']}, not the ENU "
          "origin")
    check(graph_dev < LIO_GRAPH_AGREE, f"FactorGraphLio card vs CPU {graph_dev:.3g} ≥ "
          f"{LIO_GRAPH_AGREE}")
    check(np.isfinite(g_card).all() and all(b < a for a, b in chi2_card),
          "a FactorGraphLio solve did not lower chi2")
    return out


# ---------------------------------------------------------------------------
# phase 12: the submap Schur solve
# ---------------------------------------------------------------------------


def geo_err(a, b):
    """Largest |log(a⁻¹ b)| component over a set of poses (rad or m)."""
    from lmsf_slam_tpu_torch.common import se3np

    d = se3np.pose_between(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return float(np.abs(se3np.pose_log(d)).max())


def bench_graph():
    """``bench.py::bench_posegraph``'s graph from its seed, through the port's
    host se3: a 1905-vertex helix, odometry edges with σ 0.01 rad / 0.05 m,
    96 exact loop edges, the initial guess integrated from the odometry.
    Returns (ground truth, unpadded graph, graph padded to 2048 with the tail
    and vertex 0 fixed)."""
    from lmsf_slam_tpu_torch.common import se3np

    rng = np.random.default_rng(0)
    V = SCHUR_VERTICES
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
    for _ in range(96):
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
    P = SCHUR_PADDED
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


def timed(fn, repeats, warm_up=True):
    """(result of the last call, ms of each call): host clock around calls
    that end in a read-back, after one warm-up call."""
    import torch

    out = fn() if warm_up else None
    ms = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def fused_start(device):
    """The merged sessions' database (``eval_fused/fused_db.npz``, saved after
    the reference's solve) on ``device``, its poses perturbed by a seeded
    random walk along the keyframes (σ 0.01 rad / 0.05 m a step, bench.py's
    odometry noise, each pose moved in its own frame; keyframe 0, the gauge,
    stays); returns (database, its solved poses, the start)."""
    from lmsf_slam_tpu_torch.backend import KeyframeDatabase
    from lmsf_slam_tpu_torch.common import se3np

    db = KeyframeDatabase.load(FUSED_DB, device=device)
    n = db.n_keyframes
    solved = db.map_poses[:n].copy()
    rng = np.random.default_rng(1)
    steps = np.concatenate([rng.normal(0, FUSED_WALK[0], (n, 3)),
                            rng.normal(0, FUSED_WALK[1], (n, 3))], axis=1)
    steps[0] = 0.0
    walk = np.cumsum(steps, axis=0)
    start = np.stack([se3np.pose_retract(solved[i], walk[i]) for i in range(n)]).astype(np.float32)
    db.map_poses[:n] = start
    return db, solved, start


def phase_schur():
    """The submap Schur solve on the card: bench.py's 2048-vertex graph at 16
    submaps beside the replicated solve, and the merged sessions' database
    through ``LifelongBackend.optimize(full=True)`` as
    ``scripts/fuse_sessions.py`` configures it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lmsf_slam_tpu_torch.backend import LifelongBackend, LifelongConfig
    from lmsf_slam_tpu_torch.backend.pose_graph import PoseGraphParams, optimize_pose_graph
    from lmsf_slam_tpu_torch.evaluation import ate_stats
    from lmsf_slam_tpu_torch.parallel import optimize_pose_graph_schur, partition_graph

    # (a) bench.py's graph: 60 GN iterations, huber on the loop edges
    params = PoseGraphParams(gn_iters=60, pcg_iters=128)
    gt, plain, padded = bench_graph()
    V = SCHUR_VERTICES
    part = partition_graph(padded["edges_ij"], padded["emask"], SCHUR_PADDED, SCHUR_SUBMAPS,
                           padded["fixed"])

    def schur(device, p=params, dtype=torch.float32):
        kw = dict(padded)
        poses = torch.as_tensor(kw.pop("poses"), device=device, dtype=dtype)
        out, stats = optimize_pose_graph_schur(poses, **kw, n_submaps=SCHUR_SUBMAPS, params=p)
        return out.cpu().numpy(), stats

    def replicated():
        t = {k: torch.as_tensor(v, device="cuda") for k, v in plain.items()}
        out, stats = optimize_pose_graph(**t, params=params)
        return out.cpu().numpy(), stats

    first, _ = schur("cuda")  # the warm-up, kept to hold the card to itself
    (s_out, s_stats), s_ms = timed(lambda: schur("cuda"), SCHUR_REPEATS, warm_up=False)
    (r_out, r_stats), r_ms = timed(replicated, 1, warm_up=False)  # the card is warm
    t0 = time.perf_counter()
    c_out, c_stats = schur("cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    s_ate = ate_stats(s_out[:V], gt).rmse
    r_ate = ate_stats(r_out, gt).rmse
    c_ate = ate_stats(c_out[:V], gt).rmse
    cpu_dev = float(np.max(np.abs(c_out - s_out)))
    chi2_rel = abs(float(c_stats.chi2_final) / float(s_stats.chi2_final) - 1.0)
    # the solve in float64: all of it on the card, its first iterations on
    # the card and on the CPU
    (d_out, d_stats), d_ms = timed(lambda: schur("cuda", dtype=torch.float64), 1, warm_up=False)
    short = params._replace(gn_iters=SCHUR_F64_ITERS)
    f64_dev = float(np.max(np.abs(schur("cuda", short, torch.float64)[0]
                                  - schur("cpu", short, torch.float64)[0])))
    # where a GN iteration's time goes: three of them traced
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        schur("cuda", params._replace(gn_iters=3))
        torch.cuda.synchronize()
    it = profile_counts(prof, 3)
    bench = {
        "vertices": V, "padded": SCHUR_PADDED, "submaps": SCHUR_SUBMAPS,
        "interior_slots": part.m, "separator_slots_a_submap": part.k,
        "separator_slots": part.n_sep, "separators": int((part.sep_ids >= 0).sum()),
        "edge_slots_a_submap": int(part.e_idx.shape[1]),
        "schur_ms": s_ms, "schur_ms_median": float(np.median(s_ms)),
        "schur_iterations": int(s_stats.iterations),
        "schur_chi2": [float(s_stats.chi2_initial), float(s_stats.chi2_final)],
        "schur_ate_m": s_ate, "replicated_ms": r_ms, "replicated_iterations": int(r_stats.iterations),
        "replicated_chi2": [float(r_stats.chi2_initial), float(r_stats.chi2_final)],
        "replicated_ate_m": r_ate, "schur_cpu_ms": cpu_ms, "cpu_max_abs_pose_diff": cpu_dev,
        "cpu_iterations": int(c_stats.iterations), "cpu_chi2": float(c_stats.chi2_final),
        "cpu_chi2_rel": chi2_rel, "cpu_ate_m": c_ate,
        "f64_ms": d_ms, "f64_iterations": int(d_stats.iterations),
        "f64_chi2": float(d_stats.chi2_final), "f64_ate_m": ate_stats(d_out[:V], gt).rmse,
        "f32_vs_f64_card": float(np.max(np.abs(s_out - d_out))),
        "f64_cpu_iterations": SCHUR_F64_ITERS, "f64_cpu_max_abs_pose_diff": f64_dev,
        "repeats_bit_equal": bool(np.array_equal(first, s_out)),
        "per_iteration": {k: v for k, v in it.items() if k != "rows"}, "top": it["rows"][:10],
    }
    log("schur", f"bench graph ({V} vertices padded to {SCHUR_PADDED}, {SCHUR_SUBMAPS} submaps: "
        f"{part.m} interior slots, {bench['separators']} separators in {part.n_sep} slots, "
        f"{part.k} a submap, {bench['edge_slots_a_submap']} edge slots a submap): Schur "
        f"{bench['schur_ms_median']:.1f} ms a solve (median of {SCHUR_REPEATS}: "
        + ", ".join(f"{m:.1f}" for m in s_ms) + f"), {bench['schur_iterations']} GN iterations, "
        f"chi2 {bench['schur_chi2'][0]:.6g} → {bench['schur_chi2'][1]:.6g}, ATE {s_ate:.4f} m "
        f"(limit {SCHUR_ATE_LIMIT}); replicated optimize_pose_graph {r_ms[0]:.1f} ms, "
        f"{bench['replicated_iterations']} iterations, chi2 {bench['replicated_chi2'][1]:.6g}, "
        f"ATE {r_ate:.4f} m; the CPU {cpu_ms:.0f} ms ({bench['cpu_iterations']} iterations, chi2 "
        f"{bench['cpu_chi2']:.6g}, {chi2_rel:.2g} from the card's (limit {SCHUR_BENCH_CHI2_RTOL}), "
        f"ATE {c_ate:.4f} m), card vs CPU poses max |Δ| {cpu_dev:.3g}; two card runs bit-equal: "
        f"{bench['repeats_bit_equal']}")
    log("schur", f"in float64: {d_ms[0]:.1f} ms on the card, {bench['f64_iterations']} iterations, "
        f"chi2 {bench['f64_chi2']:.6g}, ATE {bench['f64_ate_m']:.4f} m, max |Δ| "
        f"{bench['f32_vs_f64_card']:.3g} from the float32 solve; card vs CPU after "
        f"{SCHUR_F64_ITERS} iterations max |Δ| {f64_dev:.3g} (limit {SCHUR_F64_AGREE})")
    log("schur", f"a GN iteration (3 traced): {it['device_ms']:.3f} ms busy, {it['device_events']:.0f} "
        f"device events, device-to-host {it['dtoh']:g}, host-to-device {it['htod']:g}, host waits "
        f"{it['waits']:g}; top: " + "; ".join(f"{k[:40]} {ms:.3f} ms ×{c:g}" for k, ms, c in it["rows"][:5]))
    check(np.isfinite(s_out).all(), "non-finite pose from the Schur solve")
    check(s_ate < SCHUR_ATE_LIMIT, f"Schur solve ATE {s_ate:.4f} m ≥ {SCHUR_ATE_LIMIT} m")
    check(chi2_rel < SCHUR_BENCH_CHI2_RTOL and abs(c_ate - s_ate) < SCHUR_BENCH_ATE_AGREE,
          f"Schur solve card vs CPU: chi2 {chi2_rel:.3g} apart, ATE {abs(c_ate - s_ate):.3g} m")
    check(bench["repeats_bit_equal"], "two card runs of the Schur solve differ")
    check(f64_dev < SCHUR_F64_AGREE,
          f"Schur solve in float64 card vs CPU {f64_dev:.3g} ≥ {SCHUR_F64_AGREE}")

    # (b) the merged sessions' database through the backend
    cfg = dict(schur_submaps=SCHUR_SUBMAPS, schur_min_vertices=FUSED_MIN_VERTICES)

    def backend_solve(device, **kw):
        db, solved, start = fused_start(device)
        backend = LifelongBackend(db=db, config=LifelongConfig(**kw))

        def once():
            db.map_poses[:db.n_keyframes] = start
            return backend.optimize(full=True)

        return backend, solved, start, once

    sb, solved, start, s_once = backend_solve("cuda", **cfg)
    stats, f_ms = timed(s_once, SCHUR_REPEATS)
    n = sb.db.n_keyframes
    f_out = sb.db.map_poses[:n].copy()
    rb, _, _, r_once = backend_solve("cuda")  # schur_submaps=0: the replicated optimize_full
    r_stats, fr_ms = timed(r_once, SCHUR_REPEATS)
    fr_out = rb.db.map_poses[:n].copy()
    cb, _, _, c_once = backend_solve("cpu", **cfg)
    c_once()
    fc_out = cb.db.map_poses[:n].copy()
    # at a budget where both converge: the Schur solve on the card, the
    # replicated one on the CPU (its PCG is launch-bound on the card)
    tight = PoseGraphParams(**TIGHT)
    tb, _, _, t_once = backend_solve("cuda", pose_graph=tight, **cfg)
    t_stats = t_once()
    t_out = tb.db.map_poses[:n].copy()
    tr, _, _, tr_once = backend_solve("cpu", pose_graph=tight)
    t0 = time.perf_counter()
    tr_stats = tr_once()
    tr_ms = (time.perf_counter() - t0) * 1e3
    tr_out = tr.db.map_poses[:n].copy()
    runs = dict(sb.solver_runs)
    chi2 = [float(stats.chi2_initial), float(stats.chi2_final)]
    vs_rep = geo_err(t_out, tr_out)
    f_cpu = float(np.max(np.abs(fc_out - f_out)))
    fused = {
        "keyframes": int(n), "edges": int(sb.db.n_edges), "solver_runs": runs,
        "iterations": int(stats.iterations), "chi2": chi2,
        "reference_chi2_final": FUSED_CHI2, "start_vs_solved": geo_err(start, solved),
        "schur_ms": f_ms, "schur_ms_median": float(np.median(f_ms)),
        "replicated_ms": fr_ms, "replicated_ms_median": float(np.median(fr_ms)),
        "replicated_iterations": int(r_stats.iterations),
        "replicated_chi2": [float(r_stats.chi2_initial), float(r_stats.chi2_final)],
        "default_schur_vs_replicated": geo_err(f_out, fr_out),
        "schur_vs_solved_on_disk": geo_err(f_out, solved), "cpu_max_abs_pose_diff": f_cpu,
        "tight": TIGHT, "tight_schur_iterations": int(t_stats.iterations),
        "tight_schur_chi2": float(t_stats.chi2_final),
        "tight_replicated_cpu_ms": tr_ms, "tight_replicated_iterations": int(tr_stats.iterations),
        "tight_replicated_chi2": float(tr_stats.chi2_final), "tight_schur_vs_replicated": vs_rep,
        "tight_schur_vs_solved_on_disk": geo_err(t_out, solved),
    }
    log("schur", f"merged sessions ({n} keyframes, {fused['edges']} edges; the start "
        f"{fused['start_vs_solved']:.3f} from the solved poses): optimize(full=True) "
        f"{fused['schur_ms_median']:.1f} ms a solve (median of {SCHUR_REPEATS}: "
        + ", ".join(f"{m:.1f}" for m in f_ms) + f"), solver runs {runs}, "
        f"{fused['iterations']} GN iterations, chi2 {chi2[0]:.6g} → {chi2[1]:.6g} (the "
        f"reference's solve on disk: {FUSED_CHI2:.6g}), {fused['schur_vs_solved_on_disk']:.3g} "
        f"from its poses; replicated optimize_full {fused['replicated_ms_median']:.1f} ms "
        f"({fused['replicated_iterations']} iterations, chi2 {fused['replicated_chi2'][1]:.6g}, "
        f"{fused['default_schur_vs_replicated']:.3g} from the Schur solve); card vs CPU "
        f"{f_cpu:.3g} (limit {SCHUR_AGREE})")
    log("schur", f"at {TIGHT}: Schur (card) {fused['tight_schur_iterations']} iterations, chi2 "
        f"{fused['tight_schur_chi2']:.6g}; replicated (CPU, {tr_ms:.0f} ms) "
        f"{fused['tight_replicated_iterations']} iterations, chi2 "
        f"{fused['tight_replicated_chi2']:.6g}; Schur vs replicated max |Δ| {vs_rep:.3g} (limit "
        f"{SCHUR_VS_REPLICATED}); Schur vs the reference's poses on disk "
        f"{fused['tight_schur_vs_solved_on_disk']:.3g}")
    check(runs["full_schur"] == 1 + SCHUR_REPEATS and runs["full_replicated"] == 0,
          f"the merged sessions' solves ran {runs}, not the Schur path")
    check(cb.solver_runs["full_schur"] == 1 and tb.solver_runs["full_schur"] == 1
          and rb.solver_runs["full_schur"] == 0, "a solve took the wrong path")
    check(abs(chi2[1] - FUSED_CHI2) <= FUSED_CHI2_SLACK * FUSED_CHI2,
          f"chi2 after the solve {chi2[1]:.6g}, not within {FUSED_CHI2_SLACK:.0%} of {FUSED_CHI2:.6g}")
    check(vs_rep < SCHUR_VS_REPLICATED, f"Schur vs replicated poses {vs_rep:.3g}")
    check(f_cpu < SCHUR_AGREE, f"merged sessions' solve card vs CPU {f_cpu:.3g} ≥ {SCHUR_AGREE}")
    return {"bench_graph": bench, "merged_sessions": fused}


# ---------------------------------------------------------------------------
# phase 13: two LiDARs with online hand-eye calibration
# ---------------------------------------------------------------------------

DUAL_X = (0.0, 0.0, 30.0, 0.0, -0.6, 0.3)  # yaw in degrees, then metres


def dual_extrinsic():
    from lmsf_slam_tpu_torch.common import se3np

    r = np.deg2rad(np.asarray(DUAL_X[:3]))
    return se3np.make_pose(se3np.so3_exp_quat(r), np.asarray(DUAL_X[3:])).astype(np.float32)


def dual_config(**kw):
    """``tests/test_multilidar.py::dual_config`` at the default feature
    widths (16 × 900 a LiDAR: 384 edge + 1536 surf each, twice that fused)."""
    from lmsf_slam_tpu_torch.backend import LoopConfig
    from lmsf_slam_tpu_torch.calibration import HandEyeConfig
    from lmsf_slam_tpu_torch.ops.registration import RegistrationParams
    from lmsf_slam_tpu_torch.system import FeatureParams, SystemConfig

    d = dict(
        n_lidars=2, feature=FeatureParams(), tracker_window=8,
        registration=RegistrationParams(max_iters=8, max_corr_dist=2.0),
        map_update_trans=0.15, keyframe_trans=0.6,
        handeye=HandEyeConfig(min_pairs=6, min_rot_angle=0.06, screw_rot_tol=0.05,
                              screw_trans_tol=0.1),
        calib_refine_frames=12, loop=LoopConfig(min_frame_interval=10**9),
    )
    d.update(kw)
    return SystemConfig(**d)


def dual_course(n):
    """The reference scenario's world sizes and wavy 3-axis trajectory, the
    sub sensor at the extrinsic; scans of 16 × 900 to 40 m in host memory."""
    from lmsf_slam_tpu_torch.common import se3np
    from lmsf_slam_tpu_torch.datasets import make_sim_world, simulate_scan

    rng = np.random.default_rng(33)
    world = make_sim_world(rng, extent=22.0, n_boxes=10, n_cylinders=18)
    poses = [se3np.pose_identity()]
    for i in range(1, n):
        xi = np.array([0.10 * np.sin(0.7 * i), 0.10 * np.cos(1.1 * i), 0.12, 0.3, 0.0, 0.0])
        poses.append(se3np.pose_compose(poses[-1], se3np.se3_exp(xi)))
    base = se3np.make_pose(np.array([1.0, 0.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.4]))
    traj = np.stack([se3np.pose_compose(base, p) for p in poses]).astype(np.float32)
    x = dual_extrinsic()
    scans = [[simulate_scan(world, p, rng, rings=16, width=900, max_range=40.0, noise=0.01,
                            device="cpu")
              for p in (p0, np.float32(se3np.pose_compose(p0, x)))] for p0 in traj]
    return traj, scans


def phase_dual():
    """Two LiDARs through ``MultiLidarSystem.process`` on the card: the
    extrinsic calibrated online (hand-eye, refinement, fused tracking), then a
    short run with the extrinsic given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lmsf_slam_tpu_torch import _build
    from lmsf_slam_tpu_torch.common import se3np
    from lmsf_slam_tpu_torch.evaluation import ate_stats
    from lmsf_slam_tpu_torch.ops import knn as K
    from lmsf_slam_tpu_torch.system import MultiLidarSystem

    traj, scans = dual_course(DUAL_FRAMES)
    gt = se3np.pose_between(traj[:1], traj)
    system = MultiLidarSystem(dual_config(), device="cuda")
    shapes = {}
    knn_cuda = K.knn_cuda

    def census(q, qm, r, rm, k, *a, **kw):  # the k-NN shapes this path meets
        key = (int(q.shape[0]), int(r.shape[0]), int(k))
        shapes[key] = shapes.get(key, 0) + 1
        return knn_cuda(q, qm, r, rm, k, *a, **kw)

    torch.cuda.synchronize()
    _build.reset_launches()
    K.knn_cuda = census
    rows, profiled = [], {0: [], 1: [], 2: []}
    try:
        for i, pair in enumerate(scans):
            phase = system.calib_status
            before = dict(_build.launches)
            if i >= 2 and len(profiled[phase]) < DUAL_PROFILE:  # a trace, not timed
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    res = system.process(pair, 0.1 * i)
                    torch.cuda.synchronize()
                profiled[phase].append((res.is_keyframe, profile_counts(prof, 1)))
                ms = None
            else:
                t0 = time.perf_counter()
                res = system.process(pair, 0.1 * i)
                ms = (time.perf_counter() - t0) * 1e3
            rows.append({"phase": phase, "ms": ms, "keyframe": res.is_keyframe,
                         "after": res.calib_status, "matches": res.num_matches,
                         **{k: _build.launches.get(k, 0) - before.get(k, 0)
                            for k in ("knn", "knn_merge", "projector")}})
    finally:
        K.knn_cuda = knn_cuda
    launches = dict(_build.launches)
    est = system.trajectory()
    ate = ate_stats(est, gt).rmse if np.isfinite(est).all() else float("nan")
    x = system.extrinsics[0]
    d = se3np.pose_between(np.asarray(x, np.float64), dual_extrinsic()) if x is not None else None
    te = float(np.linalg.norm(d[4:])) if d is not None else float("inf")
    re = float(np.rad2deg(np.linalg.norm(se3np.so3_log(d[:4])))) if d is not None else float("inf")

    def per_phase(p):
        sel = [r for r in rows if r["phase"] == p]
        ms = [r["ms"] for r in sel[1 if p == 0 else 0:] if r["ms"] is not None]  # not frame 0
        # a keyframe frame adds the backend's copies: frames without one, where profiled
        prof = [c for kf, c in profiled[p] if not kf] or [c for _, c in profiled[p]]
        return {
            "frames": len(sel), "ms_median": float(np.median(ms)) if ms else None,
            "profiled": [{"is_keyframe": kf, **{k: v for k, v in c.items() if k != "rows"}}
                         for kf, c in profiled[p]],
            "ms_p90": float(np.percentile(ms, 90)) if ms else None,
            **{f"{k}_a_frame": float(np.mean([r[k] for r in sel])) if sel else None
               for k in ("knn", "knn_merge", "projector")},
            **{f"{k}_a_frame": float(np.mean([c[k] for c in prof])) if prof else None
               for k in ("dtoh", "htod", "waits", "device_events", "device_ms")},
        }

    phases = {name: per_phase(p) for p, name in ((0, "hand_eye"), (1, "refine"), (2, "fused"))}

    # the same scans on the CPU over the first frames
    cpu = MultiLidarSystem(dual_config(), device="cpu")
    t0 = time.perf_counter()
    odom_cpu = np.stack([cpu.process(scans[i], 0.1 * i).odom_pose for i in range(DUAL_CPU_FRAMES)])
    cpu_ms = (time.perf_counter() - t0) * 1e3 / DUAL_CPU_FRAMES
    odom = np.stack([r.odom_pose for r in system.results])
    dev_cpu = float(np.max(np.abs(odom_cpu - odom[:DUAL_CPU_FRAMES])))

    # a second run with the extrinsic given: fused from the first frame
    known = MultiLidarSystem(dual_config(extrinsics=(dual_extrinsic(),)), device="cuda")
    k_status, k_ms = [], []
    for i in range(DUAL_KNOWN_FRAMES):
        t0 = time.perf_counter()
        k_status.append(known.process(scans[i], 0.1 * i).calib_status)
        k_ms.append((time.perf_counter() - t0) * 1e3)
    k_ate = ate_stats(known.trajectory(), gt[:DUAL_KNOWN_FRAMES]).rmse

    status = [r["after"] for r in rows]
    out = {
        "frames": DUAL_FRAMES, "status": status, "phases": phases, "rows": rows,
        "extrinsic": None if x is None else np.asarray(x).tolist(),
        "extrinsic_err_m": te, "extrinsic_err_deg": re, "ate_m": ate,
        "keyframes": int(system.backend.db.n_keyframes),
        "knn_launches": launches.get("knn", 0), "knn_merge_launches": launches.get("knn_merge", 0),
        "projector_launches": launches.get("projector", 0),
        "knn_shapes": {f"{q}x{r} k={k}": c for (q, r, k), c in sorted(shapes.items())},
        "cpu_frames": DUAL_CPU_FRAMES, "cpu_max_abs_pose_diff": dev_cpu, "cpu_frame_ms": cpu_ms,
        "known_status": k_status, "known_ms": k_ms, "known_ate_m": k_ate,
        "known_ms_median": float(np.median(k_ms[1:])),
    }
    first = status.index(2) if 2 in status else None
    log("dual", f"{DUAL_FRAMES} frames of two LiDARs (16 × 900 each): phase 1 from frame "
        f"{status.index(1) + 1 if 1 in status else None}, fused from frame "
        f"{None if first is None else first + 1}; extrinsic error {te:.4f} m / {re:.3f}° (limits "
        f"{DUAL_EXTRINSIC_LIMIT[0]} m / {DUAL_EXTRINSIC_LIMIT[1]}°); ATE {ate:.4f} m (limit "
        f"{DUAL_ATE_LIMIT}); {out['keyframes']} keyframes; card vs CPU over {DUAL_CPU_FRAMES} "
        f"frames max |Δpose| {dev_cpu:.3g} (CPU {cpu_ms:.0f} ms a frame)")
    for name, ph in phases.items():
        log("dual", f"{name}: {ph['frames']} frames, ms median {ph['ms_median']}, p90 "
            f"{ph['ms_p90']}; knn {ph['knn_a_frame']} (+{ph['knn_merge_a_frame']} merges) and "
            f"projector {ph['projector_a_frame']} launches a frame; profiled frames without a "
            f"keyframe (of {DUAL_PROFILE}): device-to-host {ph['dtoh_a_frame']}, host-to-device "
            f"{ph['htod_a_frame']}, host waits {ph['waits_a_frame']}, {ph['device_events_a_frame']} "
            f"device events, {ph['device_ms_a_frame']} ms busy")
    log("dual", "k-NN shapes met (Q x N k: launches): " + ", ".join(
        f"{k}: {v}" for k, v in out["knn_shapes"].items()))
    log("dual", f"known extrinsic, {DUAL_KNOWN_FRAMES} frames: status {sorted(set(k_status))}, ms "
        f"median {out['known_ms_median']:.2f} (first {k_ms[0]:.1f}), ATE {k_ate:.4f} m")
    check(np.isfinite(est).all(), "non-finite pose on the dual course")
    check(system.calib_status == 2 and status == sorted(status),
          f"the calibration did not reach the fused phase in order: {status}")
    check(te < DUAL_EXTRINSIC_LIMIT[0] and re < DUAL_EXTRINSIC_LIMIT[1],
          f"extrinsic error {te:.4f} m / {re:.3f}°")
    check(ate < DUAL_ATE_LIMIT, f"dual ATE {ate:.4f} m ≥ {DUAL_ATE_LIMIT} m")
    check(dev_cpu < CPU_AGREE, f"dual card vs CPU {dev_cpu:.3g} ≥ {CPU_AGREE}")
    check(all(s == 2 for s in k_status) and k_ate < DUAL_ATE_LIMIT,
          f"the known-extrinsic run: status {k_status}, ATE {k_ate:.4f} m")
    check(all(phases[p][f"{k}_a_frame"] for p in phases for k in ("knn", "knn_merge", "projector")),
          "a phase of the dual course launched no k-NN, merge or projector kernel")
    check((DUAL_SHAPES[0][1], DUAL_SHAPES[0][2], DUAL_SHAPES[0][3]) in shapes,
          f"the fused frame's k-NN shape {DUAL_SHAPES[0][0]} did not occur")
    return out


def ptxas_summary(lines):
    """One line of the compiler's per-kernel resource report: the most
    registers a thread, the most static shared memory, the spills."""
    import re

    text = " ".join(lines)
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    smem = [int(x) for x in re.findall(r"(\d+) bytes smem", text)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
    if not regs:
        return " | ".join(lines)
    return (f"{len(regs)} kernel instances, at most {max(regs)} registers a thread and "
            f"{max(smem, default=0)} bytes of static shared memory; spill stores: "
            f"{sum(spills)} bytes")


def city_phases():
    """Phases city, persist and merge, with their temporary files."""
    shutil.rmtree(TMP, ignore_errors=True)
    os.makedirs(TMP)
    try:
        course = CityCourse()
        city, holder = phase_city(course)
        persist, checkpoint = phase_persist(course, holder)
        sessions = phase_merge(course, checkpoint)
    finally:
        shutil.rmtree(TMP, ignore_errors=True)
    return city, persist, sessions


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number of the run to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lmsf_slam_tpu_torch import _build
    from lmsf_slam_tpu_torch.ops import knn as K

    t_start = time.perf_counter()
    sources = ["knn", "projector"]
    _build.build(sources)  # one nvcc a source, all started together
    info = {}
    for name in sources:
        _build.load(name)
        info[name] = _build.build_info.get(name, {"seconds": 0.0, "ptxas": ["already built"]})
        log("build", f"{name}.cu in {info[name]['seconds']:.2f} s; "
            + ptxas_summary(info[name]["ptxas"]))

    seconds = {"build": time.perf_counter() - t_start}

    jacobi = {}

    def run(name, fn, *a):  # a phase, with its wall time and its projector matrices
        t0 = time.perf_counter()
        with JacobiTally() as tally:
            out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        jacobi[name] = c = tally.counts()
        if c["matrices"]:
            log(name, f"projector: {c['jacobi']} of {c['matrices']} matrices took the Jacobi path "
                f"({c['sweeps']} sweeps, at most {c['sweeps_max']}), the others were screened")
        return out

    kernel = run("kernel", phase_kernel, K)
    traj, scans = run("course", make_course)
    proj = run("projector", phase_projector, scans)
    sl = run("slice", phase_slice, traj, scans)
    prof = run("profile", phase_profile, scans, sl["frame_ms_median"])
    loop_traj, loop_scans = run("loop course", make_loop_course)
    be, first_run = run("backend", phase_backend, loop_traj, loop_scans)
    reboot = run("reboot", phase_reboot, loop_traj, loop_scans, first_run)
    del first_run
    asyn = run("async", phase_async, loop_traj, loop_scans, be)
    del loop_scans
    city, persist, sessions = run("city+persist+merge", city_phases)
    lio = run("lio", phase_lio, prof)
    schur = run("schur", phase_schur)
    dual = run("dual", phase_dual)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    surf = kernel["surf 1536x16384 k=5"]
    edge = kernel["edge 384x8192 k=5"]
    nn1 = kernel["nn1 1920x24576 k=1"]
    merge = kernel["merge at surf"]
    timed_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "splits", "blocks",
                  "with_neighbors_ms", "call_ms")
    source = "lmsf_slam_tpu_torch/csrc/knn.cu"
    replaces = "lmsf_slam_tpu/ops/pallas_knn.py:43"
    line = {"kernels": [{
        "name": "knn",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": lio["knn_launches"],
        "launches_lio": lio["knn_launches"],
        "launches_city": city["knn_launches"],
        "launches_looped_course": be["knn_launches"],
        "launches_front_end_slice": sl["knn_launches"],
        "launches_reboot": reboot["knn_launches"],
        "launches_async": asyn["knn_launches"],
        "launches_reboot_from_disk": persist["knn_launches"],
        "launches_align_sessions": sessions["knn_launches"],
        "launches_dual": dual["knn_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel.values()),
        "ms": surf["ms"], "plain_ms": surf["plain_ms"], "bound_ms": surf["bound_ms"],
        "bound_by": surf["bound_by"], "library_ms": surf["library_ms"],
        "shape": "1536x16384 k=5, scan and merge kernels together",
        "empty_launch_ms": surf["empty_launch_ms"],
        "lanes": K.LANES, "tile": K.TILE, "threads": K.THREADS,
        "surf_1536x16384": {k: surf[k] for k in timed_keys},
        "edge_384x8192": {k: edge[k] for k in timed_keys},
        "nn1_1920x24576": {k: nn1[k] for k in timed_keys},
        **{name.split()[2]: {k: kernel[name][k] for k in timed_keys}
           for name, _, _ in BACKEND_SHAPES},
        **{"city_" + name.split()[-2] + "_" + name.split()[-1].replace("=", ""):
           {k: kernel[name][k] for k in timed_keys} for name, _, _, _ in CITY_SHAPES},
        **{"dual_" + name.split()[-2] + "_" + name.split()[-1].replace("=", ""):
           {k: kernel[name][k] for k in timed_keys} for name, _, _, _ in DUAL_SHAPES},
    }, {
        "name": "knn_merge",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": lio["knn_merge_launches"],
        "launches_lio": lio["knn_merge_launches"],
        "launches_city": city["knn_merge_launches"],
        "launches_looped_course": be["knn_merge_launches"],
        "launches_front_end_slice": sl["knn_merge_launches"],
        "launches_reboot": reboot["knn_merge_launches"],
        "launches_async": asyn["knn_merge_launches"],
        "launches_reboot_from_disk": persist["knn_merge_launches"],
        "launches_align_sessions": sessions["knn_merge_launches"],
        "launches_dual": dual["knn_merge_launches"],
        "max_abs_err": merge["max_abs_err"],
        "ms": merge["ms"], "plain_ms": merge["plain_ms"], "bound_ms": merge["bound_ms"],
        "bound_by": merge["bound_by"], "library_ms": merge["library_ms"],
        "shape": f"{merge['Q']}x{merge['splits']}x{merge['k']} partial lists",
    }, {
        "name": "projector",
        "route": "cuda",
        "source": "lmsf_slam_tpu_torch/csrc/projector.cu",
        # no TPU kernel: the reference's jnp.linalg.eigh of the projector
        "replaces": "lmsf_slam_tpu/ops/registration.py:207",
        "launches": lio["projector_launches"],
        "launches_lio": lio["projector_launches"],
        "launches_city": city["projector_launches"],
        "launches_looped_course": be["projector_launches"],
        "launches_front_end_slice": sl["projector_launches"],
        "launches_reboot": reboot["projector_launches"],
        "launches_async": asyn["projector_launches"],
        "launches_reboot_from_disk": persist["projector_launches"],
        "launches_align_sessions": sessions["projector_launches"],
        "launches_dual": dual["projector_launches"],
        "max_abs_err": proj["max_abs_err"],
        "ms": proj["ms"], "plain_ms": proj["plain_ms"], "bound_ms": proj["bound_ms"],
        "bound_by": proj["bound_by"], "library_ms": proj["library_ms"],
        "shape": "one 6x6 matrix a launch, screened (the path's)", "call_ms": proj["call_ms"],
        "ms_jacobi": proj["ms_jacobi"], "empty_launch_ms": proj["empty_launch_ms"],
        "screened_of_path_matrices": f"{proj['screened']} of {2 * PROJECTOR_PER_FRAME}",
        "jacobi_of_matrices": {name: [c["jacobi"], c["matrices"]]
                               for name, c in jacobi.items() if c["matrices"]},
        **{f"{k}_{name}": v for name, r in proj["timed"].items() for k, v in r.items()
           if k in ("ms", "plain_ms", "library_ms", "bound_ms")},
    }]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "build": info, "kernel": kernel, "projector": proj, "slice": sl,
                       "profile": prof, "backend": be, "reboot": reboot, "async": asyn,
                       "city": city, "persist": persist, "merge": sessions, "lio": lio,
                       "schur": schur, "dual": dual, "phase_seconds": seconds,
                       "projector_jacobi": jacobi,
                       "seconds": time.perf_counter() - t_start},
                      fh, indent=1)
    log("done", f"all phases in {time.perf_counter() - t_start:.0f} s: " + ", ".join(
        f"{name} {sec:.0f}" for name, sec in seconds.items()))
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
