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

Then the card's name and power limit, one JSON line of kernel numbers, and
the result line ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import argparse
import json
import os
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
    ] + [(name, Q, N, 5, 0, 0.7, False, None) for name, Q, N in BACKEND_SHAPES]
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
        if name.startswith(("edge", "surf", "nn1", "loop", "loc")):
            timed[name] = (q, qm, r, rm, k)
            continue
        log("kernel", f"{name}: S={S} (slices of {slice_len}), {blocks} blocks; agrees with "
            f"knn_plain, max |Δd| {err:.3g}, near-tie rows {n_tie}"
            + ("; equal to the single-scan model, indices included" if small else ""))

    for name in ("edge 384x8192 k=5", "surf 1536x16384 k=5"):
        check(results[name]["blocks"] >= 264,
              f"{name}: grid of {results[name]['blocks']} blocks, fewer than 264")
    for name, _, _ in BACKEND_SHAPES:  # choose_splits gives a sane grid at the new shapes
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
        "final_mode": backend.mode.name, "solver_runs": runs,
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
        "launches": be["knn_launches"],
        "launches_front_end_slice": sl["knn_launches"],
        "launches_reboot": reboot["knn_launches"],
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
    }, {
        "name": "knn_merge",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": be["knn_merge_launches"],
        "launches_front_end_slice": sl["knn_merge_launches"],
        "launches_reboot": reboot["knn_merge_launches"],
        "max_abs_err": merge["max_abs_err"],
        "ms": merge["ms"], "plain_ms": merge["plain_ms"], "bound_ms": merge["bound_ms"],
        "bound_by": merge["bound_by"], "library_ms": merge["library_ms"],
        "shape": f"{merge['Q']}x{merge['splits']}x{merge['k']} partial lists",
    }]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "build": info, "kernel": kernel, "slice": sl,
                       "profile": prof, "backend": be, "reboot": reboot,
                       "seconds": time.perf_counter() - t_start},
                      fh, indent=1)
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
