#!/usr/bin/env python3
"""Run the city inputs of ``chip_smoke.py``'s phases ndt and kitti through
the reference (``lmsf_slam_tpu``) and the port on the CPU, and print what
each gives.

    JAX_PLATFORMS=cpu python scripts/port_city_checks.py ndt [--keyframe 12]
    JAX_PLATFORMS=cpu python scripts/port_city_checks.py kitti [--frames 40] [--city-features]

``ndt``: the city run (the configuration of phase city, backend inline) up to
the keyframe, then its frame registered by NDT against the 10 keyframes
before it (their stored clouds at their ground-truth poses) from several
starts off the truth, by both packages' ``register_ndt`` on the same voxel
statistics; prints the translation and rotation error of each.

``kitti``: the first frames of the LIO city course written as a KITTI
sequence (``chip_smoke.write_kitti_sequence``, on the CPU) under
``build/port_city_checks``, then read back by each package's
``KittiSequence`` and run through ``MultiLidarSystem`` with
``scripts/evaluate.py::run_kitti``'s configuration (with
``--city-features``: the city course's feature settings); prints each
frame's odometry distance from the course.

The scans come from the port's simulator (numpy seeded), so both packages
see the same points. Times printed are CPU wall times, not device numbers.
"""
import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STARTS = {"0 m": ((0.0, 0.0, 0.0), 0.0), "0.05 m / 0.5°": ((0.03, -0.04, 0.0), 0.5),
          "0.25 m / 0°": ((0.15, -0.2, 0.0), 0.0), "0.25 m / 2°": ((0.15, -0.2, 0.0), 2.0)}


def _error(truth, pose):
    from lmsf_slam_tpu_torch.common import se3np

    d = se3np.pose_between(np.asarray(truth, np.float64), np.asarray(pose, np.float64))
    return round(float(np.linalg.norm(d[4:])), 4), round(float(np.linalg.norm(se3np.so3_log(d[:4]))), 5)


def check_ndt(keyframe):
    import jax.numpy as jnp
    import torch

    import chip_smoke
    from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
    from lmsf_slam_tpu.ops import registration as jr
    from lmsf_slam_tpu_torch.common import se3np
    from lmsf_slam_tpu_torch.common.pointcloud import PointBatch
    from lmsf_slam_tpu_torch.ops.registration import register_ndt
    from lmsf_slam_tpu_torch.ops.voxel import voxel_downsample, voxel_gaussians
    from lmsf_slam_tpu_torch.system import MultiLidarSystem

    course = chip_smoke.CityCourse(device="cpu")
    system = MultiLidarSystem(chip_smoke.city_config()._replace(async_backend=False),
                              device="cpu")
    i = 0
    while system.backend.db.n_keyframes <= keyframe:
        system.process(course.scan(i, movers=True), 0.1 * i)
        i += 1
    db = system.backend.db
    frames = np.round(db.stamps[:keyframe + 1] / 0.1).astype(int)
    gt = course.gt_in_first_map_frame(frames)
    pts = []
    for j in range(keyframe - chip_smoke.NDT_MAP_KEYFRAMES, keyframe):
        for xyz, m in ((db.edge_xyz[j], db.edge_mask[j]), (db.surf_xyz[j], db.surf_mask[j])):
            pts.append(se3np.quat_rotate(gt[j][:4], np.asarray(xyz)[np.asarray(m)]) + gt[j][4:])
    map_xyz = np.concatenate(pts).astype(np.float32)
    scan = course.scan(int(frames[keyframe]), movers=True)
    src = voxel_downsample(scan, chip_smoke.NDT_SRC_VOXEL, chip_smoke.NDT_SRC_CAPACITY)
    g = voxel_gaussians(PointBatch(torch.as_tensor(map_xyz),
                                   torch.ones(len(map_xyz), dtype=torch.bool)), 1.0, 16384)
    jg = {k: jnp.asarray(v.numpy()) for k, v in g.items()}
    jsrc = JPB(jnp.asarray(src.xyz.numpy()), jnp.asarray(src.mask.numpy()))
    truth = np.asarray(gt[keyframe], np.float64)
    out = {"keyframe": keyframe, "frame": int(frames[keyframe]), "map_points": len(map_xyz),
           "src_points": int(src.mask.sum())}
    for name, ((dx, dy, dz), deg) in STARTS.items():
        off = se3np.make_pose(se3np.so3_exp_quat(np.array([0.0, 0.0, np.deg2rad(deg)])),
                              np.array([dx, dy, dz]))
        init = np.asarray(se3np.pose_compose(truth, off), np.float32)
        p = register_ndt(src, g, torch.as_tensor(init))
        j = jr.register_ndt(jsrc, jg, jnp.asarray(init))
        out[name] = {"port": _error(truth, p.pose.numpy()), "port_iterations": int(p.iterations),
                     "reference": _error(truth, np.asarray(j.pose)),
                     "reference_iterations": int(j.iterations)}
    return out


def check_kitti(frames, city_features):
    import argparse as ap

    import chip_smoke
    from lmsf_slam_tpu.backend import LifelongConfig as JLifelong
    from lmsf_slam_tpu.datasets.kitti import KittiSequence as JSequence
    from lmsf_slam_tpu.ops.registration import RegistrationParams as JReg
    from lmsf_slam_tpu.system import FeatureParams as JFeat
    from lmsf_slam_tpu.system import MultiLidarSystem as JSystem
    from lmsf_slam_tpu.system import SystemConfig as JConfig
    from lmsf_slam_tpu_torch.common import se3np
    from lmsf_slam_tpu_torch.datasets.kitti import KittiSequence
    from lmsf_slam_tpu_torch.system import MultiLidarSystem

    course = chip_smoke.CityCourse(device="cpu")
    root = os.path.join(ROOT, "build", "port_city_checks")
    shutil.rmtree(root, ignore_errors=True)
    chip_smoke.write_kitti_sequence(course, frames, root, device="cpu")
    ev = chip_smoke.evaluate_torch()
    cfg = ev.kitti_config(ap.Namespace(sync=True))
    feat = dict(rings=64, width=1800)
    if city_features:
        cfg = cfg._replace(feature=chip_smoke.city_config().feature)
        feat = cfg.feature._asdict()
    jcfg = JConfig(feature=JFeat(**feat), registration=JReg(max_iters=8, max_corr_dist=2.0),
                   keyframe_trans=1.0, async_backend=False, deskew=True,
                   lifelong=JLifelong(optimize_window=50))
    gt = np.stack([se3np.pose_between(course.traj[0], course.traj[i]) for i in range(frames)])
    out = {"frames": frames, "city_features": city_features}
    for name, system, seq in (("port", MultiLidarSystem(cfg, device="cpu"),
                               KittiSequence(root, "00", device="cpu")),
                              ("reference", JSystem(jcfg), JSequence(root, "00"))):
        t0 = time.perf_counter()
        odom = []
        for i, (stamp, scan) in enumerate(seq):
            if i >= frames:
                break
            odom.append(np.asarray(system.process(scan, stamp).odom_pose))
        err = np.linalg.norm(np.stack(odom)[:, 4:] - gt[:, 4:], axis=1)
        out[name] = {"odom_err_unaligned_m": np.round(err, 3).tolist(),
                     "cpu_s": round(time.perf_counter() - t0, 1)}
    shutil.rmtree(root, ignore_errors=True)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what", choices=["ndt", "kitti"])
    parser.add_argument("--keyframe", type=int, default=12)
    parser.add_argument("--frames", type=int, default=40)
    parser.add_argument("--city-features", action="store_true")
    args = parser.parse_args()
    if args.what == "ndt":
        print(json.dumps(check_ndt(args.keyframe)))
    else:
        print(json.dumps(check_kitti(args.frames, args.city_features)))


if __name__ == "__main__":
    main()
