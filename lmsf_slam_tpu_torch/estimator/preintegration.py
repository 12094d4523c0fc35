"""IMU preintegration over scan intervals.

Counterpart of ``lmsf_slam_tpu/estimator/preintegration.py``: integrate
gyro/accel between two lidar keyframes into a bias-corrected relative motion
(Δq, Δv, Δp) with its covariance and first-order bias Jacobians (Forster-style
preintegration), usable as the front end's motion prediction and as an IMU
between-factor in the LIO graph (:mod:`..backend.lio_graph`).

The reference's ``lax.scan`` over a padded window is a Python loop over the
samples here; padded samples (``valid`` False) integrate with dt = 0, as in
the reference, so a padded window gives the delta of its valid samples.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..common import se3


class PreintegratedImu(NamedTuple):
    dq: torch.Tensor  # (4,) Δ rotation (body frame at start → end)
    dv: torch.Tensor  # (3,) Δ velocity (start body frame)
    dp: torch.Tensor  # (3,) Δ position (start body frame)
    dt: torch.Tensor  # () total time
    cov: torch.Tensor  # (9,9) covariance of [δθ, δv, δp]
    # first-order bias Jacobians
    dq_dbg: torch.Tensor  # (3,3) ∂δθ/∂bg
    dv_dbg: torch.Tensor  # (3,3)
    dv_dba: torch.Tensor  # (3,3)
    dp_dbg: torch.Tensor  # (3,3)
    dp_dba: torch.Tensor  # (3,3)


def preintegrate(
    gyro: torch.Tensor,  # (N,3)
    acc: torch.Tensor,  # (N,3)
    dts: torch.Tensor,  # (N,) duration of each sample interval
    valid: torch.Tensor,  # (N,) bool — padded windows
    bg: torch.Tensor,
    ba: torch.Tensor,
    gyro_noise: float = 1e-3,
    acc_noise: float = 1e-2,
) -> PreintegratedImu:
    """Integrate a (padded) IMU window into a preintegrated delta."""
    dev = gyro.device
    f32 = dict(dtype=torch.float32, device=dev)
    I3 = torch.eye(3, **f32)
    dq = se3.quat_identity(device=dev)
    dv = torch.zeros(3, **f32)
    dp = torch.zeros(3, **f32)
    T = torch.zeros((), **f32)
    cov = torch.zeros((9, 9), **f32)
    Jqg, Jvg, Jva, Jpg, Jpa = (torch.zeros((3, 3), **f32) for _ in range(5))
    dts = torch.where(valid, dts, 0.0)
    for i in range(gyro.shape[0]):
        dt = dts[i]
        w_c = gyro[i] - bg
        a_c = acc[i] - ba
        R = se3.quat_to_matrix(dq)
        # nominal
        Ra = R @ a_c
        dp_n = dp + dv * dt + 0.5 * Ra * dt * dt
        dv_n = dv + Ra * dt
        dq_n = se3.quat_mul(dq, se3.so3_exp_quat(w_c * dt))
        # covariance of [δθ δv δp] (first-order)
        Rw = se3.so3_exp_matrix(w_c * dt)
        RS = R @ se3.skew(a_c)
        A = torch.eye(9, **f32)
        A[0:3, 0:3] = Rw.T
        A[3:6, 0:3] = -RS * dt
        A[6:9, 0:3] = -0.5 * RS * dt * dt
        A[6:9, 3:6] = I3 * dt
        qd = torch.cat([
            torch.full((3,), gyro_noise**2, **f32) * dt,
            torch.full((3,), acc_noise**2, **f32) * dt,
            torch.full((3,), 0.25 * acc_noise**2, **f32) * dt**3 + 1e-12,
        ])
        cov_n = A @ cov @ A.T + torch.diag(qd)
        # bias Jacobians (Forster eq. 69-71 first order)
        Jqg_n = Rw.T @ Jqg - I3 * dt
        Jvg_n = Jvg - RS @ Jqg * dt
        Jva_n = Jva - R * dt
        Jpg_n = Jpg + Jvg * dt - 0.5 * RS @ Jqg * dt * dt
        Jpa_n = Jpa + Jva * dt - 0.5 * R * dt * dt
        dq, dv, dp, T, cov = dq_n, dv_n, dp_n, T + dt, cov_n
        Jqg, Jvg, Jva, Jpg, Jpa = Jqg_n, Jvg_n, Jva_n, Jpg_n, Jpa_n
    return PreintegratedImu(dq, dv, dp, T, cov, Jqg, Jvg, Jva, Jpg, Jpa)


def predict_pose(
    pose_i: torch.Tensor,  # (7,) pose at interval start (world)
    v_i: torch.Tensor,  # (3,) velocity at start (world)
    pre: PreintegratedImu,
    gravity: float = 9.81,
):
    """World-frame (pose, velocity) at the interval end from a delta."""
    g = torch.zeros(3, dtype=torch.float32, device=pose_i.device)
    g[2] = -gravity
    q_i = se3.pose_quat(pose_i)
    p_i = se3.pose_trans(pose_i)
    T = pre.dt
    p_j = p_i + v_i * T + 0.5 * g * T * T + se3.quat_rotate(q_i, pre.dp)
    v_j = v_i + g * T + se3.quat_rotate(q_i, pre.dv)
    q_j = se3.quat_mul(q_i, pre.dq)
    return se3.make_pose(q_j, p_j), v_j


def correct_bias(pre: PreintegratedImu, dbg: torch.Tensor, dba: torch.Tensor):
    """First-order re-linearization of the delta at an updated bias."""
    dq = se3.quat_mul(pre.dq, se3.so3_exp_quat(pre.dq_dbg @ dbg))
    dv = pre.dv + pre.dv_dbg @ dbg + pre.dv_dba @ dba
    dp = pre.dp + pre.dp_dbg @ dbg + pre.dp_dba @ dba
    return pre._replace(dq=dq, dv=dv, dp=dp)
