#!/usr/bin/env python3
"""Run the looped simulator course of ``chip_smoke.py`` (its scans, its
configuration) through the reference ``lmsf_slam_tpu.MultiLidarSystem`` and,
with ``--port``, through the port on the CPU, and print what each decided:
keyframes, loop edges, modes, ATE in the map frame and of odometry alone.

    JAX_PLATFORMS=cpu python scripts/port_loop_course.py [--seed 0] [--frames 120] [--port]

Used to pick a course seed on which the reference closes a loop. The scans
come from the port's simulator (numpy seeded), so both packages see the same
points. Timings printed here are CPU wall times, not device numbers.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def summary(results, backend, traj, seconds):
    from lmsf_slam_tpu_torch.common import se3np
    from lmsf_slam_tpu_torch.evaluation import ate_stats

    n = len(results)
    gt = np.stack([se3np.pose_between(traj[0], traj[i]) for i in range(n)])
    est = np.stack([np.asarray(r.map_pose) for r in results])
    odom = np.stack([np.asarray(r.odom_pose) for r in results])
    db = backend.db
    closed = [i for i, r in enumerate(results) if r.loop_closed]
    return {
        "frames": n, "keyframes": int(db.n_keyframes), "edges": int(db.n_edges),
        "loop_closed_at_frames": closed,
        "loop_edges": db.eij[:db.n_edges][db.eloop[:db.n_edges]].tolist(),
        "final_mode": backend.mode.name, "solver_runs": dict(backend.solver_runs),
        "ate_map_m": float(ate_stats(est, gt).rmse), "ate_odom_m": float(ate_stats(odom, gt).rmse),
        "cpu_seconds": seconds,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--port", action="store_true", help="also run the port on the CPU")
    args = ap.parse_args()

    import chip_smoke

    traj, scans = chip_smoke.make_loop_course(args.seed, args.frames)
    pcfg = chip_smoke.backend_config()

    import jax.numpy as jnp

    from lmsf_slam_tpu.backend import LifelongConfig, LoopConfig
    from lmsf_slam_tpu.common.pointcloud import PointBatch
    from lmsf_slam_tpu.ops.registration import RegistrationParams
    from lmsf_slam_tpu.system import FeatureParams, MultiLidarSystem, SystemConfig

    loop = {k: v for k, v in pcfg.loop._asdict().items() if not k.endswith("_params")}
    jcfg = SystemConfig(
        feature=FeatureParams(**pcfg.feature._asdict()),
        registration=RegistrationParams(**pcfg.registration._asdict()),
        map_update_trans=pcfg.map_update_trans, keyframe_trans=pcfg.keyframe_trans,
        lifelong=LifelongConfig(optimize_window=pcfg.lifelong.optimize_window),
        loop=LoopConfig(**loop),
    )
    system = MultiLidarSystem(jcfg)
    t0 = time.perf_counter()
    for i, s in enumerate(scans):
        system.process(PointBatch(jnp.asarray(s.xyz.numpy()), jnp.asarray(s.mask.numpy()),
                                  jnp.asarray(s.attr.numpy())), 0.1 * i)
    out = {"seed": args.seed,
           "reference": summary(system.results, system.backend, traj, time.perf_counter() - t0)}
    if args.port:
        from lmsf_slam_tpu_torch.system import MultiLidarSystem as PortSystem

        port = PortSystem(pcfg, device="cpu")
        t0 = time.perf_counter()
        for i, s in enumerate(scans):
            port.process(s, 0.1 * i)
        out["port_cpu"] = summary(port.results, port.backend, traj, time.perf_counter() - t0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
