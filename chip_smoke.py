#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lmsf_slam_tpu_torch``) on one card.

    python3 chip_smoke.py [--out FILE.json]

Needs one CUDA device; exits non-zero without one, or when any phase fails.
Phases, one line each:

1. build   — compile ``lmsf_slam_tpu_torch/csrc/knn.cu`` with nvcc for
             sm_90a (into ``build/kernels/``) and print ptxas' register,
             shared-memory and spill summary;
2. kernel  — hold the k-NN kernels (``knn_cuda``: the scan over reference
             slices and the merge) against the plain torch version of the
             whole function (``knn_plain``) on the card: at the slice's
             shapes (384×8192 and 1536×16384 at k=5, 1920×24576 at k=1; the
             backend's local maps of 7, 10 and 11 keyframes: 384×2688,
             384×3840, 384×4224, 1536×10752, 1536×15360, 1536×16896) and
             at the corner cases (masked queries, a size that is no multiple
             of slice or tile, duplicated references, Q=1, N=1, no valid
             reference, no valid query, k above the number of valid
             references with several slices). The small cases must also equal
             a single ascending scan ordered by (d, idx) bit for bit, and the
             result must not change with the number of slices or lanes. Then
             time kernels, plain version and ``torch.cdist`` + ``torch.topk``
             (a yardstick the port never calls) with CUDA events, beside the
             bound and the time of an empty launch;
3. slice   — 60 frames of a simulated VLP-16 course through
             ``build_fused_step(SystemConfig(), "cuda")`` and the keyframe
             gate at the default widths, one read-back per frame; checks the
             poses are finite, the ATE against ground truth, that every
             association went through the kernels (launch counters), and that
             the first 10 frames agree with the same run on the CPU;
4. profile — ``torch.profiler`` over 10 frames: device time and device events
             per frame and the kernels that take the time, beside what the
             earlier one-thread-a-query kernel read;
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
             final mode as the sync run, map-frame ATE under 0.15 m and within
             0.02 m of the sync run's. Prints sync beside async: frame times,
             keyframe-frame times, the peak backlog, ``coalesced``, stages;
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
             disk. (One cut: the submap Schur solve is off, the replicated
             full solve runs.) Checks: finite poses, a loop closed, a
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
             up, inter-session edges are loop edges, finite poses.

Temporary files go under ``build/chip_smoke_tmp`` and are removed. Then the
card's name and power limit, one JSON line of kernel numbers, and the result
line ``{"ok": true, "device": {...}}`` last.
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
PEAK_BYTES_PER_S = 3.35e12

N_FRAMES = 60
N_CPU_FRAMES = 10
ATE_LIMIT = 0.15  # m, the reference system test's threshold
CPU_AGREE = 1e-3  # m / quaternion component, card vs CPU over the first frames
KNN_PER_FRAME = 10  # 5 associations × (edge + surf) at the default cadence

# What the profile phase read on the earlier one-thread-a-query kernel, whose
# wrapper rescored and sorted with torch ops (NVIDIA H100 80GB HBM3, 700 W),
# printed beside this run's numbers.
EARLIER_KNN_MS_PER_FRAME = 4.78
EARLIER_EVENTS_PER_FRAME = 6722


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

# phases async, city, persist and merge
ASYNC_ATE_SLACK = 0.02  # m, async map-frame ATE against the sync run's
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
        (name, Q, N, k, 0, 0.7, False, None) for name, Q, N, k in CITY_SHAPES]
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
        if name.startswith(("edge", "surf", "nn1", "loop", "loc", "city")):
            timed[name] = (q, qm, r, rm, k)
            continue
        log("kernel", f"{name}: S={S} (slices of {slice_len}), {blocks} blocks; agrees with "
            f"knn_plain, max |Δd| {err:.3g}, near-tie rows {n_tie}"
            + ("; equal to the single-scan model, indices included" if small else ""))

    for name in ("edge 384x8192 k=5", "surf 1536x16384 k=5"):
        check(results[name]["blocks"] >= 264,
              f"{name}: grid of {results[name]['blocks']} blocks, fewer than 264")
    # choose_splits gives a sane grid at the backend's and the city's shapes
    for name in [c[0] for c in BACKEND_SHAPES + CITY_SHAPES]:
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
        f"{out['knn_merge_launches']}; peak device memory "
        f"{peak / 2**20:.1f} MiB; card vs CPU over {N_CPU_FRAMES} frames max |Δpose| "
        f"{dev_cpu:.3g}; keyframes {out['keyframes']}")
    return out


def phase_profile(scans, frame_ms):
    """Device time per frame and its largest kernels, over frames 2..11 of a
    fresh run (torch.profiler; "not measured" where it reports no device
    time). Busy time sums the device-side events (kernels, copies) only: a
    host op's row repeats the time of the kernels it launched. The busy share
    is taken of ``frame_ms``, the unprofiled median frame time, since the
    profiler slows the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lmsf_slam_tpu_torch.system import SystemConfig, build_fused_step
    from lmsf_slam_tpu_torch.tracker import tracker_init

    cfg = SystemConfig()
    gate_cfg = (cfg.keyframe_trans, cfg.keyframe_rot, cfg.keyframe_dt)
    tc, step = build_fused_step(cfg, "cuda")
    state, _, _ = run_frames(step, tracker_init(tc, "cuda"), scans, gate_cfg, 2)
    n = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_frames(step, state, scans[2:], gate_cfg, n)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and dev_us > 0:
            rows.append((ev.key, dev_us / 1e3 / n, ev.count / n))
    rows.sort(key=lambda x: -x[1])
    if not rows:
        log("profile", "device time: not measured (the profiler reported none)")
        return {"device_ms_per_frame": None}
    total = sum(r[1] for r in rows)
    knn_ms = sum(r[1] for r in rows if "knn_partial_kernel" in r[0] or "knn_merge_kernel" in r[0])
    launches = sum(r[2] for r in rows)
    check(knn_ms > 0, "the profile shows no k-NN kernel on the device")
    check(launches < EARLIER_EVENTS_PER_FRAME,
          f"{launches:g} device events a frame, not fewer than {EARLIER_EVENTS_PER_FRAME} "
          "(the one-thread-a-query kernel)")
    top = "; ".join(f"{k[:48]} {ms:.3f} ms ×{c:g}" for k, ms, c in rows[:6])
    log("profile", f"per frame: device busy {total:.3f} ms = {100 * total / frame_ms:.1f}% of "
        f"the {frame_ms:.2f} ms median frame (idle {100 - 100 * total / frame_ms:.1f}%), "
        f"{launches:g} device events (one-thread-a-query kernel: {EARLIER_EVENTS_PER_FRAME}); knn kernels "
        f"{knn_ms:.3f} ms (one-thread-a-query kernel: {EARLIER_KNN_MS_PER_FRAME}); profiled wall "
        f"{wall:.2f} ms; top: {top}")
    return {"profiled_wall_ms_per_frame": wall, "device_ms_per_frame": total,
            "device_busy_share": total / frame_ms, "device_events_per_frame": launches,
            "knn_device_ms_per_frame": knn_ms,
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

    def snapshot(sys_, res):
        # the first keyframes' map poses, when the last of them is stored
        if sys_.backend.db.n_keyframes == N_CPU_KEYFRAMES and not first_kf:
            first_kf["poses"] = sys_.keyframe_trajectory()
        if res.is_keyframe:
            solves.append((sys_.backend.db.n_keyframes, res.loop_closed,
                           dict(sys_.backend.solver_runs)))
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
        "knn_launches_per_backend_keyframe": knn_backend / max(n_kf_frames, 1),
        "mirror_bytes": mirror_nbytes(db), "mirror_rows": int(db._mirror["cap"]),
        "peak_device_bytes": int(peak), "cpu_keyframes_max_abs_pose_diff": dev_cpu,
        "cpu_frame_ms_median": float(np.median(np.asarray(times_cpu) * 1e3)),
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
    for name in ("knn", "knn_merge"):
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
        "knn_merge_launches": launches["knn_merge"],
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
    check(abs(ate - sync["ate_map_m"]) <= ASYNC_ATE_SLACK,
          f"async map-frame ATE {ate:.4f} m, the sync run's {sync['ate_map_m']:.4f} m")
    per_frame = 2 * 4  # as in phase backend: what the frontend thread launches
    for name in ("knn", "knn_merge"):  # the rest came from the worker thread
        check(launches.get(name, 0) > per_frame * n,
              f"{name}: {launches.get(name, 0)} launches on the async path, the frontend's "
              f"frames alone make {per_frame * n}: the worker thread launched none")
    stats = backend.timer.stats()
    out = {**frame_stats(times, [r.is_keyframe for r in results]),
           "ate_map_m": ate, "loop_edges": loop_edges, "final_mode": backend.mode.name,
           "keyframes_stored": int(db.n_keyframes), "dropped": ab.dropped,
           "coalesced": ab.coalesced, "backlog_peak": int(max(backlog)), "flush_ms": flush_ms,
           "solver_runs": dict(backend.solver_runs), "solves": backend.solve_log,
           "stage_ms": stats, "knn_launches": launches["knn"],
           "knn_merge_launches": launches["knn_merge"]}
    ab.close()
    log("async", f"{n} frames, policy coalesce: {db.n_keyframes} keyframes stored, dropped 0, "
        f"coalesced {ab.coalesced}, peak backlog {out['backlog_peak']}, final flush "
        f"{flush_ms:.1f} ms; loop edges {loop_edges}, mode {backend.mode.name}; ATE map frame "
        f"{ate:.4f} m (sync {sync['ate_map_m']:.4f} m)")
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
    dynamic-object defence and the occupancy grid of the first session; the
    submap Schur solve is off (not ported), everything else as published."""
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
            schur_submaps=0,
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
    for name in ("knn", "knn_merge"):
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
           "knn_launches": launches.get("knn", 0), "knn_merge_launches": launches.get("knn_merge", 0)}
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
    _build.build(["knn"])
    _build.load("knn")
    info = _build.build_info.get("knn", {"seconds": 0.0, "ptxas": ["already built"]})
    log("build", f"knn.cu in {info['seconds']:.2f} s; " + ptxas_summary(info["ptxas"]))

    kernel = phase_kernel(K)
    traj, scans = make_course()
    sl = phase_slice(traj, scans)
    prof = phase_profile(scans, sl["frame_ms_median"])
    loop_traj, loop_scans = make_loop_course()
    be, first_run = phase_backend(loop_traj, loop_scans)
    reboot = phase_reboot(loop_traj, loop_scans, first_run)
    del first_run
    asyn = phase_async(loop_traj, loop_scans, be)
    del loop_scans
    city, persist, sessions = city_phases()

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
        "launches": city["knn_launches"],
        "launches_city": city["knn_launches"],
        "launches_looped_course": be["knn_launches"],
        "launches_front_end_slice": sl["knn_launches"],
        "launches_reboot": reboot["knn_launches"],
        "launches_async": asyn["knn_launches"],
        "launches_reboot_from_disk": persist["knn_launches"],
        "launches_align_sessions": sessions["knn_launches"],
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
    }, {
        "name": "knn_merge",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": city["knn_merge_launches"],
        "launches_city": city["knn_merge_launches"],
        "launches_looped_course": be["knn_merge_launches"],
        "launches_front_end_slice": sl["knn_merge_launches"],
        "launches_reboot": reboot["knn_merge_launches"],
        "launches_async": asyn["knn_merge_launches"],
        "launches_reboot_from_disk": persist["knn_merge_launches"],
        "launches_align_sessions": sessions["knn_merge_launches"],
        "max_abs_err": merge["max_abs_err"],
        "ms": merge["ms"], "plain_ms": merge["plain_ms"], "bound_ms": merge["bound_ms"],
        "bound_by": merge["bound_by"], "library_ms": merge["library_ms"],
        "shape": f"{merge['Q']}x{merge['splits']}x{merge['k']} partial lists",
    }]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "build": info, "kernel": kernel, "slice": sl,
                       "profile": prof, "backend": be, "reboot": reboot, "async": asyn,
                       "city": city, "persist": persist, "merge": sessions,
                       "seconds": time.perf_counter() - t_start},
                      fh, indent=1)
    log("done", f"all phases in {time.perf_counter() - t_start:.0f} s")
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
