"""Online hand-eye (lidar-lidar extrinsic) calibration.

Counterpart of ``lmsf_slam_tpu/calibration/handeye.py``:

- screw-motion consistency check — a motion pair (primary A, sub B) is
  usable only if both increments have the same rotation angle and the same
  translation projection onto the rotation axis, which are extrinsic-
  invariant;
- rotation via the nullspace of stacked quaternion constraint matrices
  [L(q_A) − R(q_B)] q_X = 0, with a degeneracy gate on the second-smallest
  singular value so single-axis motion never yields a fake solve;
- translation by least squares of (R_A − I) t_X = R_X t_B − t_A;
- a bounded sample store (≤ 300 pose pairs).

The pair store is a fixed-capacity masked ring buffer of tensors and the
accept is branchless (``torch.where``), so adding a pair reads nothing back.
The solve is a 4×4 ``eigh`` of the accumulated Σ AᵀA (equivalent to the SVD
of the 4N×4 stack) and a 3×3 normal-equation solve; on a card torch checks
both on the host, which the calibration phases pay once a sampled pair.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..common import se3


class HandEyeConfig(NamedTuple):
    capacity: int = 300  # max stored pose pairs
    min_rot_angle: float = 0.05  # rad — pair must carry rotation signal
    screw_rot_tol: float = 0.02  # rad — |angle_A − angle_B| gate
    screw_trans_tol: float = 0.05  # m — |d_A − d_B| axis-projection gate
    degeneracy_gate: float = 0.25  # 2nd-smallest singular value floor
    min_pairs: int = 15


class HandEyeState(NamedTuple):
    q_a: torch.Tensor  # (C, 4) primary rotation increments
    t_a: torch.Tensor  # (C, 3)
    q_b: torch.Tensor  # (C, 4) sub-lidar rotation increments
    t_b: torch.Tensor  # (C, 3)
    mask: torch.Tensor  # (C,) bool
    write_idx: torch.Tensor  # int32
    count: torch.Tensor  # int32 — total accepted pairs


class HandEyeResult(NamedTuple):
    extrinsic: torch.Tensor  # (7,) pose of sub lidar in primary frame (T_A_B)
    ok: torch.Tensor  # bool — degeneracy gate + enough pairs
    quality: torch.Tensor  # 2nd-smallest singular value of the rotation system
    rot_residual: torch.Tensor  # mean |[L−R] q_X| over pairs
    trans_residual: torch.Tensor  # rms translation equation residual (m)


def handeye_init(config: HandEyeConfig = HandEyeConfig(), device="cuda") -> HandEyeState:
    C = config.capacity

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return HandEyeState(
        q_a=z(C, 4), t_a=z(C, 3), q_b=z(C, 4), t_b=z(C, 3),
        mask=torch.zeros(C, dtype=torch.bool, device=device),
        write_idx=torch.zeros((), dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def handeye_add_pair(
    state: HandEyeState,
    pose_a: torch.Tensor,  # (7,) primary odometry increment over the interval
    pose_b: torch.Tensor,  # (7,) sub-lidar odometry increment (same interval)
    config: HandEyeConfig = HandEyeConfig(),
) -> HandEyeState:
    """Branchless accept of one motion pair after the screw-motion check."""
    wa = se3.so3_log(se3.pose_quat(pose_a))
    wb = se3.so3_log(se3.pose_quat(pose_b))
    ang_a = torch.linalg.vector_norm(wa)
    ang_b = torch.linalg.vector_norm(wb)
    # translation projected on the rotation axis (screw pitch · angle)
    d_a = torch.sum(se3.pose_trans(pose_a) * wa) / torch.clamp(ang_a, min=1e-9)
    d_b = torch.sum(se3.pose_trans(pose_b) * wb) / torch.clamp(ang_b, min=1e-9)
    accept = (
        (ang_a > config.min_rot_angle)
        & (torch.abs(ang_a - ang_b) < config.screw_rot_tol)
        & (torch.abs(d_a - d_b) < config.screw_trans_tol)
    )
    i = state.write_idx.long()
    slot = torch.arange(config.capacity, device=state.mask.device) == i
    put = (slot & accept)[:, None]  # the row written, if the pair is accepted
    return HandEyeState(
        q_a=torch.where(put, se3.pose_quat(pose_a), state.q_a),
        t_a=torch.where(put, se3.pose_trans(pose_a), state.t_a),
        q_b=torch.where(put, se3.pose_quat(pose_b), state.q_b),
        t_b=torch.where(put, se3.pose_trans(pose_b), state.t_b),
        mask=state.mask | put[:, 0],
        write_idx=torch.where(accept, (state.write_idx + 1) % config.capacity, state.write_idx),
        count=torch.where(accept, torch.clamp(state.count + 1, max=config.capacity),
                          state.count),
    )


def handeye_solve(state: HandEyeState, config: HandEyeConfig = HandEyeConfig()) -> HandEyeResult:
    """Closed-form rotation + least-squares translation from the stored pairs."""
    m = state.mask.to(torch.float32)
    # rotation: A_i = L(q_a) − R(q_b); nullspace of Σ AᵀA (4×4)
    A = se3.quat_left_matrix(state.q_a) - se3.quat_right_matrix(state.q_b)
    M = torch.einsum("nij,nik,n->jk", A, A, m)
    eigval, eigvec = torch.linalg.eigh(M)  # ascending
    q_x = se3.quat_normalize(eigvec[:, 0])
    # singular values of the stacked system are sqrt(eigvals of M)
    quality = torch.sqrt(torch.clamp(eigval[1], min=0.0))
    n_pairs = torch.clamp(torch.sum(m), min=1.0)
    rot_res = torch.sum(
        torch.linalg.vector_norm(torch.einsum("nij,j->ni", A, q_x), dim=-1) * m) / n_pairs

    # translation: (R_a − I) t_x = R_x t_b − t_a
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    lhs = se3.quat_to_matrix(state.q_a) - eye
    rhs = se3.quat_rotate(q_x[None, :], state.t_b) - state.t_a
    H = torch.einsum("nij,nik,n->jk", lhs, lhs, m) + 1e-9 * eye
    g = torch.einsum("nij,ni,n->j", lhs, rhs, m)
    t_x = torch.linalg.solve(H, g)
    resid = torch.einsum("nij,j->ni", lhs, t_x) - rhs
    trans_res = torch.sqrt(torch.sum(torch.sum(resid * resid, -1) * m) / n_pairs)
    ok = (quality > config.degeneracy_gate) & (torch.sum(state.mask) >= config.min_pairs)
    return HandEyeResult(
        extrinsic=se3.make_pose(q_x, t_x),
        ok=ok,
        quality=quality,
        rot_residual=rot_res,
        trans_residual=trans_res,
    )
