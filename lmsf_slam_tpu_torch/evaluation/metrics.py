"""Trajectory evaluation: ATE / RPE statistics and KITTI-format trajectory IO.

Counterpart of ``lmsf_slam_tpu/evaluation/metrics.py``: Umeyama SE(3)
alignment → absolute trajectory error (host numpy in float64, as there),
relative pose error over a fixed frame delta, and KITTI's 3×4 row-major pose
files. RPE and the trajectory files go through the port's SE(3) in float32 on
the CPU, as the reference's go through its float32 ``se3``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..common import se3


class TrajectoryStats(NamedTuple):
    rmse: float
    mean: float
    median: float
    std: float
    max: float
    sse: float
    n: int

    @staticmethod
    def from_errors(err: np.ndarray) -> "TrajectoryStats":
        err = np.asarray(err, np.float64)
        return TrajectoryStats(
            rmse=float(np.sqrt(np.mean(err**2))),
            mean=float(np.mean(err)),
            median=float(np.median(err)),
            std=float(np.std(err)),
            max=float(np.max(err)),
            sse=float(np.sum(err**2)),
            n=int(err.shape[0]),
        )


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (optionally similarity) alignment est→gt.

    Args: (N, 3) point sets. Returns (R (3,3), t (3,), s scalar) minimizing
    ‖gt − (s·R·est + t)‖².
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    de = est - mu_e
    dg = gt - mu_g
    cov = dg.T @ de / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = np.mean(np.sum(de**2, axis=1))
        s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_stats(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True) -> TrajectoryStats:
    """Absolute trajectory error of (N,7) pose arrays (evo-style); ``align``
    applies Umeyama SE(3) alignment first."""
    p_est = np.asarray(est_poses, np.float64)[:, 4:]
    p_gt = np.asarray(gt_poses, np.float64)[:, 4:]
    if p_est.shape != p_gt.shape:
        raise ValueError(f"trajectory shapes differ: {p_est.shape} vs {p_gt.shape}")
    if align and p_est.shape[0] >= 3:
        R, t, _ = umeyama_alignment(p_est, p_gt)
        p_est = p_est @ R.T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return TrajectoryStats.from_errors(err)


def _poses(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def rpe_stats(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1) -> TrajectoryStats:
    """Relative pose (translation) error over a fixed frame delta."""
    est, gt = _poses(est_poses), _poses(gt_poses)
    de = se3.pose_between(est[:-delta], est[delta:])
    dg = se3.pose_between(gt[:-delta], gt[delta:])
    err = torch.linalg.vector_norm(se3.pose_trans(se3.pose_between(dg, de)), dim=-1)
    return TrajectoryStats.from_errors(err.numpy())


def save_kitti_trajectory(poses: np.ndarray, path: str):
    """Write (N,7) poses as KITTI 3×4 row-major lines."""
    mats = se3.pose_to_matrix(_poses(poses)).numpy()[:, :3, :]
    np.savetxt(path, mats.reshape(-1, 12), fmt="%.9e")


def load_kitti_trajectory(path: str) -> np.ndarray:
    """Read KITTI 3×4 row-major pose lines into (N,7) float32 poses."""
    return kitti_rows_to_poses(np.loadtxt(path).reshape(-1, 3, 4))


def kitti_rows_to_poses(rows: np.ndarray, conjugate: np.ndarray | None = None) -> np.ndarray:
    """(N,3,4) row-major pose rows → (N,7) float32 poses, optionally
    conjugated as ``conjugate⁻¹ · T · conjugate`` (in float64, before the
    rounding to float32)."""
    mats = np.concatenate(
        [rows, np.tile(np.array([[[0, 0, 0, 1.0]]]), (rows.shape[0], 1, 1))], axis=1)
    if conjugate is not None:
        mats = np.linalg.inv(conjugate) @ mats @ conjugate
    return se3.matrix_to_pose(torch.as_tensor(mats, dtype=torch.float32)).numpy()
