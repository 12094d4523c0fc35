#!/usr/bin/env python3
"""End-to-end SLAM evaluation through the port's public System API.

``scripts/evaluate.py`` run through ``lmsf_slam_tpu_torch`` instead of the
JAX package: ``MultiLidarSystem`` over a dataset, on the card by default,
with evo-style ATE / RPE statistics.

Usage:
  python scripts/evaluate_torch.py --dataset sim --frames 120 [--loop]
  python scripts/evaluate_torch.py --dataset city [--extras | --movers] [--imu] [--sync]
  python scripts/evaluate_torch.py --dataset city --boot-from S.npz [--ref-traj est_path.txt]
  python scripts/evaluate_torch.py --dataset kitti --root /data/kitti --seq 00
  (--device cpu runs it on the CPU; --save-db S.npz saves the lifelong database)

Writes ``result.json`` (also printed on stdout), ``est_path.txt``,
``ground_truth.txt`` and ``backend_history.csv`` under ``--out``, and the map
(and occupancy) renders where matplotlib imports. Random draws come from
``numpy.random.default_rng(--seed)``, so the scans are not the JAX script's.
Timings are host-clock times on the device named in ``result.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lmsf_slam_tpu_torch.backend import LifelongConfig, LoopConfig  # noqa: E402
from lmsf_slam_tpu_torch.common import se3np  # noqa: E402
from lmsf_slam_tpu_torch.evaluation import ate_stats, rpe_stats, save_kitti_trajectory  # noqa: E402
from lmsf_slam_tpu_torch.ops.registration import RegistrationParams  # noqa: E402
from lmsf_slam_tpu_torch.system import FeatureParams, MultiLidarSystem, SystemConfig  # noqa: E402


def gt_from(traj0, traj):
    """Ground truth relative to the first pose (the odometry's origin)."""
    return np.stack([se3np.pose_between(traj0, p) for p in traj]).astype(np.float32)


def drive(system, scans, progress=None):
    """Feed (stamp, scan, kwargs) through ``process``; (wall s, s a frame)."""
    lat = []
    t0 = time.perf_counter()
    for i, (stamp, scan, kw) in enumerate(scans):
        tf = time.perf_counter()
        system.process(scan, stamp, **kw)
        lat.append(time.perf_counter() - tf)
        if progress is not None:
            progress(i)
    system.flush()
    return time.perf_counter() - t0, lat


def sim_config(args) -> SystemConfig:
    return SystemConfig(
        feature=FeatureParams(rings=16, width=900),
        registration=RegistrationParams(max_iters=8, max_corr_dist=2.0),
        map_update_trans=0.2,
        keyframe_trans=0.8,
        async_backend=not args.sync,
        lifelong=LifelongConfig(optimize_window=50),
        loop=LoopConfig(
            min_frame_interval=20, exclude_recent=10, detect_spacing=1,
            search_radius=6.0, adjacent_window=3, refine_score_thresh=0.3,
        ) if args.loop else LoopConfig(min_frame_interval=10**9),
    )


def run_sim(args):
    from lmsf_slam_tpu_torch.datasets import make_sim_world, make_trajectory, simulate_scan

    rng = np.random.default_rng(args.seed)
    world = make_sim_world(rng, extent=30.0, n_boxes=14, n_cylinders=24)
    traj = make_trajectory(args.frames, radius=9.0, loop=args.loop, device="cpu").numpy().copy()
    traj[:, 6] = 1.4
    system = MultiLidarSystem(sim_config(args), device=args.device)
    scans = ((0.1 * i, simulate_scan(world, traj[i], rng, rings=16, width=900,
                                     max_range=60.0, noise=0.01, device=args.device), {})
             for i in range(args.frames))
    wall, lat = drive(system, scans)
    return system, system.trajectory(), gt_from(traj[0], traj), wall, lat


def city_config(args, extras: bool, reboot: bool = False) -> SystemConfig:
    """``scripts/evaluate.py::run_city`` (and ``run_city_lifelong`` with
    ``reboot``) in the port."""
    from lmsf_slam_tpu_torch.datasets import HDL64

    trim_kw, extras_kw = {}, {}
    if extras:
        from lmsf_slam_tpu_torch.mapping import OccupancyConfig

        # probation + carving in the tracker, trimmed registration, carving of
        # stored keyframes, the unsupported-point gate and the occupancy grid
        trim_kw = dict(trim_rel=3.0)
        extras_kw = dict(dynamic_carve_knn=3, dynamic_gate_unsupported=True,
                         occupancy=OccupancyConfig(size=1536, resolution=0.25))
    loc = RegistrationParams(max_iters=8, max_corr_dist=2.0, degen_rel=0.01)
    schur_kw = {} if reboot else dict(schur_submaps=16, schur_min_vertices=192)
    return SystemConfig(
        feature=FeatureParams(
            rings=HDL64["rings"], width=HDL64["width"], sectors=6, edges_per_sector=4,
            surfs_per_sector=8, range_noise=0.01, exclude_ground_edges=True,
            one_sided_occlusion=True),
        registration=RegistrationParams(max_iters=8, max_corr_dist=2.0, degen_rel=0.01,
                                        **trim_kw),
        map_update_trans=0.5,
        keyframe_trans=2.0,
        async_backend=not args.sync,
        dynamic_probation=extras,
        use_imu=args.imu and not reboot,
        lifelong=LifelongConfig(optimize_window=100, localization_params=loc, **schur_kw,
                                **extras_kw),
        loop=LoopConfig(min_frame_interval=30, exclude_recent=15, detect_spacing=2,
                        search_radius=8.0, adjacent_window=4),
    )


class City:
    """The city world, its course and its movers from ``--seed``."""

    def __init__(self, args):
        from lmsf_slam_tpu_torch.datasets import make_city_course, make_city_world, make_movers

        self.rng = np.random.default_rng(args.seed)
        self.world = make_city_world(int(self.rng.integers(2**31 - 1)))
        self.movers = make_movers(int(self.rng.integers(2**31 - 1)))
        self.traj = make_city_course()
        self.device = args.device

    def scan(self, frame, movers=False, moving=False):
        """The HDL-64 scan at ``frame`` (with ``moving``: the motion-blurred
        sweep from the previous frame), rendered on the device."""
        from lmsf_slam_tpu_torch.datasets import (
            HDL64, simulate_scan, simulate_scan_moving, world_with_movers)

        w = world_with_movers(self.world, self.movers, frame) if movers else self.world
        kw = dict(rings=HDL64["rings"], width=HDL64["width"], elev_min=HDL64["elev_min"],
                  elev_max=HDL64["elev_max"], max_range=80.0, min_range=2.5, noise=0.01,
                  device=self.device)
        if moving and frame > 0:
            return simulate_scan_moving(w, self.traj[frame - 1], self.traj[frame], self.rng, **kw)
        return simulate_scan(w, self.traj[frame], self.rng, **kw)


def run_city(args):
    import torch

    city = City(args)
    start = args.start or 0
    n = min(args.frames, city.traj.shape[0] - start) if args.frames else city.traj.shape[0] - start
    movers = args.extras or args.movers
    system = MultiLidarSystem(city_config(args, extras=args.extras), device=args.device)
    windows = None
    if args.imu:
        from lmsf_slam_tpu_torch.datasets import make_city_imu

        windows = make_city_imu(city.traj)
        # the filter lives in the odometry frame anchored at the first scan:
        # seed it with the course velocity rotated into that frame
        t = city.traj.astype(np.float64)
        va = se3np.quat_rotate(se3np.quat_conj(t[start, :4]), (t[start + 1, 4:7] - t[start, 4:7]) * 10.0)
        system._lio.eskf = system._lio.eskf._replace(
            v=torch.as_tensor(va.astype(np.float32), device=args.device))

    def scans():
        for i in range(n):
            fi = start + i  # absolute course frame: stamps identify course frames
            kw = {}
            if windows is not None and i > 0:
                kw = dict(zip(("gyro", "acc", "imu_dts"), windows[fi]))
            yield 0.1 * fi, city.scan(fi, movers=movers, moving=args.imu and i > 0), kw

    peak = [0]  # the worker's largest backlog so far

    def progress(i):
        if system._async is not None:
            peak[0] = max(peak[0], system._async.backlog)
        if args.progress and i % 100 == 0:
            print(f"# frame {i}/{n} kf={system.backend.db.n_keyframes} backlog peak={peak[0]}",
                  file=sys.stderr)

    wall, lat = drive(system, scans(), progress)
    return system, system.trajectory(), gt_from(city.traj[start], city.traj[start:start + n]), wall, lat


def run_city_lifelong(args):
    """Boot from a saved database, relocalize, then localize through a
    revisited stretch; estimates are in the first session's map frame."""
    city = City(args)
    start = args.start if args.start is not None else city.traj.shape[0] // 2
    n = args.frames or 150
    seg = city.traj[start:start + n]
    system = MultiLidarSystem.load(args.boot_from, config=city_config(args, False, reboot=True),
                                   device=args.device)
    modes = []

    def progress(i):
        modes.append(system.backend.mode.name)
        if args.progress and i % 50 == 0:
            print(f"# frame {i}/{seg.shape[0]} mode={modes[-1]}", file=sys.stderr)

    scans = ((0.1 * i, city.scan(start + i), {}) for i in range(seg.shape[0]))
    wall, lat = drive(system, scans, progress)
    est = system.trajectory()
    gt = gt_from(city.traj[0], seg)  # in the original session's map frame
    first = next((i for i, m in enumerate(modes) if m != "RELOCALIZATION"), None)
    if first is not None:
        est, gt = est[first:], gt[first:]
    extra = {"reloc_frames": sum(m == "RELOCALIZATION" for m in modes),
             "modes_seen": sorted(set(modes))}
    if args.ref_traj:
        # unaligned map-frame RMSE against the first session's estimate at the
        # same course frames
        ref = np.loadtxt(args.ref_traj).reshape(-1, 3, 4)
        lo = start + (first or 0)
        ref_t = ref[lo:lo + est.shape[0], :, 3]
        d = np.linalg.norm(est[:ref_t.shape[0], 4:] - ref_t, axis=1)
        extra["map_frame_rmse_vs_session"] = round(float(np.sqrt(np.mean(d**2))), 4)
    return system, est, gt, wall, lat, extra


def kitti_config(args) -> SystemConfig:
    """``scripts/evaluate.py::run_kitti``'s configuration: HDL-64 width, the
    azimuth-derived sweep times consumed by the tracker's deskew."""
    return SystemConfig(
        feature=FeatureParams(rings=64, width=1800),
        registration=RegistrationParams(max_iters=8, max_corr_dist=2.0),
        keyframe_trans=1.0,
        async_backend=not args.sync,
        deskew=True,
        lifelong=LifelongConfig(optimize_window=50),
    )


def run_kitti(args, config: SystemConfig | None = None):
    """A KITTI odometry sequence through the system, with ``config`` (by
    default :func:`kitti_config`)."""
    from lmsf_slam_tpu_torch.datasets.kitti import KittiSequence

    seq = KittiSequence(args.root, args.seq, device=args.device)
    gt_all = seq.ground_truth()
    system = MultiLidarSystem(config or kitti_config(args), device=args.device)
    n = min(len(seq), args.frames) if args.frames else len(seq)

    def scans():
        for i, (stamp, scan) in enumerate(seq):
            if i >= n:
                return
            yield stamp, scan, {}

    wall, lat = drive(system, scans())
    gt = gt_from(gt_all[0], gt_all[:n]) if gt_all is not None else None
    return system, system.trajectory(), gt, wall, lat


def render(args, system, est, gt):
    """The map (and occupancy) renders, where matplotlib imports."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    from lmsf_slam_tpu_torch.evaluation import render_map, render_occupancy

    db = system.backend.db
    render_map(db, os.path.join(args.out, "map.png"), est=est, gt=gt,
               title=f"{args.dataset}: {est.shape[0]} frames, {db.n_keyframes} keyframes")
    occ = system.backend.occupancy_grid()
    if occ is not None:
        render_occupancy(occ.cpu().numpy(), system.backend.config.occupancy,
                         os.path.join(args.out, "occupancy.png"))
    return True


def report(args, system, est, gt, wall, lat, extra=None) -> dict:
    """Write est_path.txt, ground_truth.txt, backend_history.csv and
    result.json under ``args.out``; returns the result."""
    import torch

    os.makedirs(args.out, exist_ok=True)
    save_kitti_trajectory(est, os.path.join(args.out, "est_path.txt"))
    # steady-state latency: drop the first frames (kernel builds, allocator)
    steady = np.asarray(lat[3:]) if len(lat) > 6 else np.asarray(lat)
    backend = system.backend
    device = torch.device(args.device)
    result = {
        "dataset": args.dataset,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "frames": int(est.shape[0]),
        "fps": round(est.shape[0] / wall, 2),
        "frame_ms_p50": round(float(np.percentile(steady, 50)) * 1e3, 2),
        "frame_ms_p90": round(float(np.percentile(steady, 90)) * 1e3, 2),
        "frame_ms_p99": round(float(np.percentile(steady, 99)) * 1e3, 2),
        "frame_ms_max": round(float(np.max(steady)) * 1e3, 2),
        "backend": "async" if system._async is not None else "sync",
        "keyframes": int(backend.db.n_keyframes),
        "mode": backend.mode.name,
    }
    if system._async is not None:
        result["dropped_keyframes"] = system._async.dropped
        result["coalesced_keyframes"] = system._async.coalesced
        result["async_policy"] = system._async.policy
    result["solver_runs"] = dict(backend.solver_runs)
    g = backend.db.graph_arrays()
    ij = g.edges_ij.cpu().numpy()[g.emask.cpu().numpy()]
    result["loop_edges"] = int(np.sum(np.abs(ij[:, 0] - ij[:, 1]) > 1))
    result["backend_stage_ms"] = {
        k: {"n": v["n"], "mean": round(v["mean_ms"], 1)}
        for k, v in sorted(backend.timer.stats().items())
    }
    with open(os.path.join(args.out, "backend_history.csv"), "w") as f:
        f.write("mode,keyframe_id,score,overlap,loop_closed\n")
        for h in backend.history:
            f.write(f"{h.mode.name},{h.keyframe_id},{h.score:.5f},"
                    f"{h.overlap:.4f},{int(h.loop_closed)}\n")
    hist_modes = [h.mode.name for h in backend.history]
    result["mode_counts"] = {m: hist_modes.count(m) for m in sorted(set(hist_modes))}
    occ = backend.occupancy_grid()
    if occ is not None:
        occ = occ.cpu().numpy()
        np.save(os.path.join(args.out, "occupancy.npy"), occ)
        result["occupancy_cells_occupied"] = int(np.sum(occ > 1.0))
    result.update(extra or {})
    if gt is not None:
        save_kitti_trajectory(gt, os.path.join(args.out, "ground_truth.txt"))
        s = ate_stats(est, gt)
        result["ate"] = {"rmse": round(s.rmse, 4), "mean": round(s.mean, 4),
                         "median": round(s.median, 4), "std": round(s.std, 4),
                         "max": round(s.max, 4)}
        if len(system.results) == gt.shape[0]:  # the front end's odometry, every frame
            odom = np.stack([r.odom_pose for r in system.results])
            result["ate_odom"] = {"rmse": round(ate_stats(odom, gt).rmse, 4)}
        if est.shape[0] > 12:
            r = rpe_stats(est, gt, delta=10)
            result["rpe_d10"] = {"rmse": round(r.rmse, 4), "mean": round(r.mean, 4),
                                 "max": round(r.max, 4)}
    result["rendered"] = render(args, system, est, gt)
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", choices=["sim", "city", "kitti"], default="sim")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--progress", action="store_true")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--loop", action="store_true", help="sim: closed loop + loop closure")
    ap.add_argument("--extras", action="store_true",
                    help="city: movers + carving + unsupported-point gate + occupancy grid")
    ap.add_argument("--movers", action="store_true",
                    help="city: movers in the world without the defence (ablation)")
    ap.add_argument("--imu", action="store_true",
                    help="city: 100 Hz IMU + motion-blurred sweeps through use_imu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", default=os.environ.get("KITTI_ROOT", ""))
    ap.add_argument("--seq", default="00")
    ap.add_argument("--out", default="eval_out_torch")
    ap.add_argument("--sync", action="store_true", help="run the backend inline")
    ap.add_argument("--save-db", default="", help="save the lifelong database here")
    ap.add_argument("--boot-from", default="",
                    help="city: boot from a saved database and relocalize")
    ap.add_argument("--ref-traj", default="",
                    help="city reboot: the first session's est_path.txt")
    ap.add_argument("--start", type=int, default=None, help="city: first course frame")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    extra = None
    if args.dataset == "sim":
        system, est, gt, wall, lat = run_sim(args)
    elif args.dataset == "city" and args.boot_from:
        system, est, gt, wall, lat, extra = run_city_lifelong(args)
    elif args.dataset == "city":
        system, est, gt, wall, lat = run_city(args)
    else:
        system, est, gt, wall, lat = run_kitti(args)
    if args.save_db:
        system.save(args.save_db)
    result = report(args, system, est, gt, wall, lat, extra)
    if system._async is not None:
        system._async.close()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
