"""The system under test: the port's ``MultiLidarSystem``, built from a
configuration file of this benchmark, and the few things the harness reads
from it (returned poses, the tracker's state before a frame, the IMU filter's
state around each frame, the keyframe store and the pose graph after the
flush, the loop verifications and the localizations it accepts, the backend's
stage timer, the worker's backlog) and the wrapper that records the k-NN
kernel's shapes.
This module is the only one of the benchmark that imports the program.
"""
from __future__ import annotations

import numpy as np
import torch

from lmsf_slam_tpu_torch.backend import KeyframeDatabase, LifelongBackend, WorkMode
from lmsf_slam_tpu_torch.backend.pose_graph import optimize_pose_graph
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch
from lmsf_slam_tpu_torch.ops import knn as knn_module
from lmsf_slam_tpu_torch.system import MultiLidarSystem
from lmsf_slam_tpu_torch.system.config import system_config_from_dict


def build(config: dict, device, storage_dir=None) -> MultiLidarSystem:
    """The system the configuration file states; ``storage_dir`` holds a
    disk-backed (memmap) keyframe store when the file asks for one."""
    cfg = system_config_from_dict(config["system"])
    if config.get("storage") == "memmap":
        f, n = cfg.feature, cfg.n_lidars
        db = KeyframeDatabase(edge_capacity=n * f.edge_capacity, surf_capacity=n * f.surf_capacity,
                              storage_dir=storage_dir, device=device)
        backend = LifelongBackend(db=db, config=cfg.lifelong, loop_config=cfg.loop)
        return MultiLidarSystem(cfg, backend=backend, device=device)
    return MultiLidarSystem(cfg, device=device)


def close(system) -> None:
    if system._async is not None:
        system._async.close()


def process(system, frame, stamp: float):
    """One frame, (scan, IMU window or None), in the one call a caller makes:
    the window goes in as ``gyro, acc, imu_dts`` where there is one."""
    scan, window = frame
    if window is None:
        return system.process(PointBatch(*scan), stamp)
    gyro, acc, dts = window
    return system.process(PointBatch(*scan), stamp, gyro=gyro, acc=acc, imu_dts=dts)


def seed_velocity(system, velocity) -> None:
    """Seed the IMU filter's velocity (body frame of the first scan) where
    the system has a filter, as a caller on a moving platform does
    (``scripts/evaluate_torch.py::run_city``)."""
    if velocity is None or system._lio is None:
        return
    lio = system._lio
    lio.eskf = lio.eskf._replace(v=torch.as_tensor(velocity, dtype=torch.float32,
                                                   device=lio.device))


FILTER_FIELDS = ("p", "v", "q", "ba", "bg", "cov")


def record_filters(system):
    """A dict that gains, for each frame the system tracks from now on, its
    stamp -> (the IMU filter's state before the frame, after it): references
    to the system's own tensors (the filter is a pure function of its state,
    so holding them copies nothing), taken around the LIO tracker's own call.
    None where the system has no filter."""
    lio = system._lio
    if lio is None:
        return None
    records = {}
    orig = lio.process_scan

    def recording(edge, surf, timestamp, *a, **kw):
        before = lio.eskf
        out = orig(edge, surf, timestamp, *a, **kw)
        records[float(timestamp)] = (before, lio.eskf)
        return out

    lio.process_scan = recording
    return records


def filter_payload(state) -> dict:
    """Host float32 copies of a filter state's fields."""
    return {k: getattr(state, k).detach().to(torch.float32).cpu().numpy()
            for k in FILTER_FIELDS}


def localizing(system) -> bool:
    return system._async.mode is WorkMode.LOCALIZATION if system._async else (
        system.backend.mode is WorkMode.LOCALIZATION)


def backlog(system) -> int:
    return system._async.backlog if system._async is not None else 0


def warm_solver(system) -> None:
    """One pose-graph solve at each padded shape the backend uses (the full
    solve's ``graph_pad_min``, the windowed solve's ``window_pad_min``), so
    that no first call of the solver falls in the window."""
    lc = system.backend.config
    dev = system.device
    for pad in sorted({lc.graph_pad_min, lc.window_pad_min}):
        n = min(24, pad)
        poses = torch.zeros(pad, 7, device=dev)
        poses[:, 0] = 1.0
        poses[:n, 4] = torch.arange(n, dtype=torch.float32, device=dev)
        ij = torch.zeros(2 * pad, 2, dtype=torch.int32, device=dev)
        ij[: n - 1, 0] = torch.arange(n - 1, device=dev)
        ij[: n - 1, 1] = torch.arange(1, n, device=dev)
        z = torch.zeros(2 * pad, 7, device=dev)
        z[:, 0] = 1.0
        z[: n - 1, 4] = 1.0
        emask = torch.arange(2 * pad, device=dev) < n - 1
        fixed = torch.arange(pad, device=dev) == 0
        optimize_pose_graph(poses, torch.arange(pad, device=dev) < n, ij, z,
                            torch.full((2 * pad, 6), 10.0, device=dev), emask, fixed=fixed,
                            edges_robust=torch.zeros(2 * pad, dtype=torch.bool, device=dev),
                            params=lc.pose_graph)
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None


def tracker_before(system):
    """The tracker's state as the next frame will find it (the tracker is a
    pure function of its state: holding the tuple copies nothing)."""
    return system.tracker_state


def tracker_state_payload(before, after) -> dict:
    """What the check reads of the tracker around one frame: of the state it
    started from, its local map's ring (write index, fill count and point
    masks) and what its motion gates read (smoothed speed, rejection
    streak); of the state it left, the pose and the ring slot the frame
    would take."""
    slot = int(before.edge_map.write_idx)
    out = {"ring": {"write_idx": slot, "count": int(before.edge_map.count),
                    "edge_mask": before.edge_map.mask.cpu(), "surf_mask": before.surf_map.mask.cpu()},
           "gate": {"speed_ema": float(before.speed_ema), "reject_streak": int(before.reject_streak)}}
    if after is not None:
        out["after"] = {
            "pose": after.pose.cpu(),
            "edge_slot": (after.edge_map.xyz[slot].cpu(), after.edge_map.mask[slot].cpu()),
            "surf_slot": (after.surf_map.xyz[slot].cpu(), after.surf_map.mask[slot].cpu()),
            "written": int(after.edge_map.write_idx) != slot}
    return out


def store(system) -> dict:
    """Keyframe store and pose graph after the flush, on the host."""
    system.flush()
    db = system.backend.db
    n, e = db.n_keyframes, db.n_edges
    return {"n": n, "stamps": np.array(db.stamps[:n]), "odom": np.array(db.odom_poses[:n]),
            "map": np.array(db.map_poses[:n]), "edge_xyz": db.edge_xyz, "edge_mask": db.edge_mask,
            "surf_xyz": db.surf_xyz, "surf_mask": db.surf_mask, "eij": np.array(db.eij[:e]),
            "z": np.array(db.ez[:e]), "sqrtw": np.array(db.esqrtw[:e]),
            "loop": np.array(db.eloop[:e])}


def stage_samples(system) -> dict:
    """The backend's stage timer: {stage: [seconds, ...]}."""
    return {k: list(v) for k, v in system.backend.timer.samples.items()}


def record_loop_verifications(system) -> list:
    """A list that gains an entry for each loop verification the system's
    backend accepts from now on: the new keyframe, the candidate, the map
    poses of the candidate's local map as the verification found them, its
    initial guess and the pose it found (host copies of a few poses, on the
    worker). Wraps this system's detector only."""
    records = []
    detector = system.backend.loop_detector
    orig = detector._verify

    def recording(db, cand_id, edge_pb, surf_pb, init_pose):
        aw = detector.config.adjacent_window
        lo, hi = max(0, cand_id - aw), min(db.n_keyframes - 1, cand_id + aw)
        poses = np.array(db.map_poses[lo:hi + 1])
        out = orig(db, cand_id, edge_pb, surf_pb, init_pose)
        if out is not None:
            records.append({"new_id": db.n_keyframes - 1, "cand": int(cand_id),
                            "ids": list(range(lo, hi + 1)), "poses": poses,
                            "init": np.asarray(init_pose, np.float32).copy(),
                            "pose": np.asarray(out[0], np.float32).copy()})
        return out

    detector._verify = recording
    return records


def record_localizations(system) -> list:
    """A list that gains an entry for each keyframe the system's backend
    localizes from now on: its stamp, the prediction it started from, the
    map poses of the stored keyframes it could draw its local map from, and
    the pose it returned. Host copies made on the worker, around the
    backend's own call; nothing is read from the card."""
    records = []
    backend = system.backend
    orig = backend._do_localization

    def recording(stamp, edge, surf, odom_pose, scan_grid=None):
        pred = np.asarray(backend._map_pose(odom_pose), np.float32).copy()
        n = backend.db.n_keyframes
        poses = np.array(backend.db.map_poses[:n])
        out = orig(stamp, edge, surf, odom_pose, scan_grid=scan_grid)
        records.append({"stamp": float(stamp), "pred": pred, "map_poses": poses,
                        "pose": np.asarray(out.map_pose, np.float32).copy()})
        return out

    backend._do_localization = recording
    return records


class KnnShapes:
    """Records each k-NN kernel call's shapes while installed: (Q, N, k,
    neighbours, query mask, reference mask). The masks are the caller's own
    tensors, held, not read, until :meth:`calls` counts them after the
    traced span."""

    def __init__(self):
        self.records = []
        self._orig = None

    def __enter__(self):
        self._orig = knn_module.knn_cuda
        orig = self._orig

        def recording(query_xyz, query_mask, ref_xyz, ref_mask, k, *args, **kw):
            self.records.append((query_xyz.shape[0], ref_xyz.shape[0], k,
                                 bool(kw.get("neighbors", False)), query_mask, ref_mask))
            return orig(query_xyz, query_mask, ref_xyz, ref_mask, k, *args, **kw)

        knn_module.knn_cuda = recording
        return self

    def __exit__(self, *exc):
        knn_module.knn_cuda = self._orig

    def calls(self):
        """[(Q, valid queries, N, valid references, k, neighbours), ...]."""
        return [(q, int(qm.sum()), n, int(rm.sum()), k, nb)
                for q, n, k, nb, qm, rm in self.records]
