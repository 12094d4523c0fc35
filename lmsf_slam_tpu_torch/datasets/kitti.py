"""KITTI odometry dataset ingest.

Counterpart of ``lmsf_slam_tpu/datasets/kitti.py``. It reads the raw KITTI
odometry layout of local files (nothing is downloaded):

    <root>/sequences/<seq>/velodyne/000000.bin   (float32 x,y,z,intensity)
    <root>/sequences/<seq>/calib.txt             (P0..P3, Tr)
    <root>/poses/<seq>.txt                       (3×4 cam0 poses)

Ground-truth poses are published in the cam0 frame; ``load_poses`` conjugates
them by the velodyne→cam0 extrinsic ``Tr`` so they live in the LiDAR frame
the SLAM system estimates in. Scans land on ``device`` (the card by default).
"""
from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from ..common.pointcloud import PointBatch
from ..evaluation.metrics import kitti_rows_to_poses
from ..native import read_f32

KITTI_SCAN_CAPACITY = 131072  # 2^17 ≥ any HDL-64 scan (~120k returns)


def read_velodyne_bin(path: str, capacity: int = KITTI_SCAN_CAPACITY,
                      device="cuda") -> PointBatch:
    """One KITTI velodyne scan → padded PointBatch on ``device``.

    attr slot 0 carries the azimuth-derived relative sweep time (an HDL-64
    spins clockwise, one revolution a scan, so the time is ``az[0] − az``
    wrapped to one turn), slot 1 the return intensity, so the deskew path is
    active on KITTI data and never consumes intensity as time. The file is
    read by the native reader (:mod:`..native`)."""
    raw = read_f32(path).reshape(-1, 4)
    az = np.arctan2(raw[:, 1], raw[:, 0])
    rel_time = np.mod(az[0] - az, 2.0 * np.pi) / (2.0 * np.pi)
    attr = np.stack([rel_time.astype(np.float32), raw[:, 3]], axis=1)
    return PointBatch.from_points(raw[:, :3], capacity, attr=attr, device=device)


def read_calib(path: str) -> np.ndarray:
    """Parse calib.txt; returns the 4×4 velodyne→cam0 transform ``Tr``."""
    with open(path) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = np.array(line.split(":")[1].split(), np.float64)
                T = np.eye(4)
                T[:3] = vals.reshape(3, 4)
                return T
    raise ValueError(f"no Tr line in {path}")


def load_poses(pose_path: str, calib_path: Optional[str] = None) -> np.ndarray:
    """GT poses as (N,7) float32 in the velodyne frame (cam0 → velo
    conjugation, in float64)."""
    rows = np.loadtxt(pose_path).reshape(-1, 3, 4)
    Tr = None
    if calib_path is not None and os.path.exists(calib_path):
        Tr = read_calib(calib_path)
    return kitti_rows_to_poses(rows, Tr)


class KittiSequence:
    """Iterable over (timestamp, PointBatch on ``device``) of one KITTI
    odometry sequence."""

    def __init__(
        self,
        root: str,
        sequence: str = "00",
        capacity: int = KITTI_SCAN_CAPACITY,
        rate_hz: float = 10.0,
        device="cuda",
    ):
        self.seq_dir = os.path.join(root, "sequences", sequence)
        self.velo_dir = os.path.join(self.seq_dir, "velodyne")
        self.pose_path = os.path.join(root, "poses", f"{sequence}.txt")
        self.calib_path = os.path.join(self.seq_dir, "calib.txt")
        self.capacity = capacity
        self.dt = 1.0 / rate_hz
        self.device = device
        if not os.path.isdir(self.velo_dir):
            raise FileNotFoundError(self.velo_dir)
        self.files = sorted(
            os.path.join(self.velo_dir, f)
            for f in os.listdir(self.velo_dir)
            if f.endswith(".bin")
        )

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self) -> Iterator[tuple[float, PointBatch]]:
        for i, f in enumerate(self.files):
            yield i * self.dt, read_velodyne_bin(f, self.capacity, self.device)

    def ground_truth(self) -> Optional[np.ndarray]:
        if os.path.exists(self.pose_path):
            return load_poses(self.pose_path, self.calib_path)
        return None
