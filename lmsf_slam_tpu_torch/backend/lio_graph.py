"""LiDAR-inertial factor graph: pose+velocity+bias states, preintegration
factors, lidar pose priors — batch GN with matrix-free PCG.

Counterpart of ``lmsf_slam_tpu/backend/lio_graph.py``: one combined 15-dim
between factor [r_θ r_v r_p r_ba r_bg] per consecutive state pair (IMU
preintegration re-linearized at the current bias, plus the bias random
walk), 6-dim unary pose priors from scan-to-map, and a host wrapper
(:class:`FactorGraphLio`) with the sliding window's periodic reset and the
failure guard on absurd velocity or bias.

As in ``backend/pose_graph.py``: per-factor Jacobians by
``torch.func.vmap(torch.func.jacfwd(...))`` of the boxplus residual, sums by
``index_add_`` (the reference's ``segment_sum``), the normal equations never
materialized (PCG with the inverted 15×15 block-Jacobi preconditioner,
``torch.linalg.inv_ex``: no host-side check). The reference's two scans have
fixed lengths (``gn_iters`` GN steps, ``pcg_iters`` PCG steps, a converged
GN step frozen by ``where``), so :func:`optimize_lio_graph` is two Python
loops that read nothing back.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..common import se3
from ..estimator.preintegration import PreintegratedImu, predict_pose

FACTOR_FIELDS = ("dq", "dv", "dp", "dt", "dq_dbg", "dv_dbg", "dv_dba", "dp_dbg", "dp_dba")
_FIELD_SHAPES = {"dq": (4,), "dv": (3,), "dp": (3,), "dt": ()} | {
    k: (3, 3) for k in FACTOR_FIELDS[4:]}


class LioGraphParams(NamedTuple):
    gn_iters: int = 8
    pcg_iters: int = 48
    damping: float = 1e-2
    gravity: float = 9.81
    converged_dx: float = 1e-6


class LioStates(NamedTuple):
    """Padded window of states: pose (N,7), vel (N,3), ba (N,3), bg (N,3)."""

    pose: torch.Tensor
    vel: torch.Tensor
    ba: torch.Tensor
    bg: torch.Tensor

    @staticmethod
    def zeros(n: int, device="cuda") -> "LioStates":
        z = torch.zeros((n, 3), dtype=torch.float32, device=device)
        return LioStates(se3.pose_identity((n,), device=device), z, z.clone(), z.clone())


class PoseLioStats(NamedTuple):
    chi2_initial: torch.Tensor
    chi2_final: torch.Tensor


def _mv(A, b):
    """Matrix (…,3,3) times vector (…,3), batched or not."""
    return (A @ b[..., None])[..., 0]


def _retract_one(pose, vel, ba, bg, dx):
    return (
        se3.pose_retract(pose, dx[..., :6]),
        vel + dx[..., 6:9],
        ba + dx[..., 9:12],
        bg + dx[..., 12:15],
    )


def _imu_residual(pose_i, vel_i, ba_i, bg_i, pose_j, vel_j, ba_j, bg_j, f, g):
    """15-dim combined IMU + bias-walk residual between states i, j.

    ``f`` carries the preintegrated delta (at linearization bias zero) plus
    its bias Jacobians; the delta is re-linearized at the CURRENT bias
    estimate (Forster first-order correction) inside the residual so bias
    states stay observable through the factor. ``g`` is the (3,) gravity
    vector [0, 0, −g].
    """
    dt = f["dt"][..., None]
    # first-order bias correction of the delta
    dq = se3.quat_mul(f["dq"], se3.so3_exp_quat(_mv(f["dq_dbg"], bg_i)))
    dv = f["dv"] + _mv(f["dv_dbg"], bg_i) + _mv(f["dv_dba"], ba_i)
    dp = f["dp"] + _mv(f["dp_dbg"], bg_i) + _mv(f["dp_dba"], ba_i)
    q_i = pose_i[..., :4]
    p_i, p_j = pose_i[..., 4:], pose_j[..., 4:]
    q_conj = se3.quat_conj(q_i)
    r_th = se3.so3_log(se3.quat_mul(se3.quat_conj(dq), se3.quat_mul(q_conj, pose_j[..., :4])))
    r_v = se3.quat_rotate(q_conj, vel_j - vel_i - g * dt) - dv
    r_p = se3.quat_rotate(q_conj, p_j - p_i - vel_i * dt - 0.5 * g * dt * dt) - dp
    r_ba = ba_j - ba_i
    r_bg = bg_j - bg_i
    return torch.cat([r_th, r_v, r_p, r_ba, r_bg], dim=-1)


def _imu_boxplus(x, si, sj, f, g):
    """Whitened IMU residual after right-perturbing both states by x = [δᵢ, δⱼ]."""
    pi, vi, bai, bgi = _retract_one(*si, x[..., :15])
    pj, vj, baj, bgj = _retract_one(*sj, x[..., 15:])
    return _imu_residual(pi, vi, bai, bgi, pj, vj, baj, bgj, f, g) * f["sqrtw"]


def _prior_boxplus(x, s, z, sqrtw):
    """Whitened 6-dim pose-prior residual log(z⁻¹ ∘ pose) after a perturbation."""
    p, _, _, _ = _retract_one(*s, x)
    return se3.pose_log(se3.pose_between(z, p)) * sqrtw


def _segment_sum(values, idx, num_segments: int):
    out = values.new_zeros((num_segments,) + values.shape[1:])
    return out.index_add_(0, idx, values)


def optimize_lio_graph(
    states: LioStates,  # padded (N, ...)
    smask: torch.Tensor,  # (N,) bool — state exists
    imu_factors: dict,  # padded (M, ...): FACTOR_FIELDS + sqrtw (M,15)
    imu_ij: torch.Tensor,  # (M,2) int state indices
    imu_mask: torch.Tensor,  # (M,)
    prior_z: torch.Tensor,  # (K,7) measured poses
    prior_idx: torch.Tensor,  # (K,) state index
    prior_sqrtw: torch.Tensor,  # (K,6)
    prior_mask: torch.Tensor,  # (K,)
    fixed: torch.Tensor | None = None,  # (N,) gauge-fixed states
    params: LioGraphParams = LioGraphParams(),
):
    """Batch GN over the LIO window. Returns (states, PoseLioStats)."""
    N = states.pose.shape[0]
    dev = states.pose.device
    if fixed is None:
        fixed = torch.zeros(N, dtype=torch.bool, device=dev)
    free = smask & ~fixed
    i_idx, j_idx = imu_ij[:, 0].long(), imu_ij[:, 1].long()
    prior_idx = prior_idx.long()
    g = torch.zeros(3, dtype=torch.float32, device=dev)
    g[2] = -params.gravity
    x_imu = states.pose.new_zeros((i_idx.shape[0], 30))
    x_prior = states.pose.new_zeros((prior_idx.shape[0], 15))
    imu_jac = torch.func.vmap(torch.func.jacfwd(_imu_boxplus), in_dims=(0, 0, 0, 0, None))
    prior_jac = torch.func.vmap(torch.func.jacfwd(_prior_boxplus))

    def gather(st, idx):
        return (st.pose[idx], st.vel[idx], st.ba[idx], st.bg[idx])

    def chi2_of(st):
        r_i = _imu_boxplus(x_imu, gather(st, i_idx), gather(st, j_idx), imu_factors, g)
        r_p = _prior_boxplus(x_prior, gather(st, prior_idx), prior_z, prior_sqrtw)
        return torch.sum(torch.where(imu_mask, torch.sum(r_i * r_i, -1), 0.0)) + torch.sum(
            torch.where(prior_mask, torch.sum(r_p * r_p, -1), 0.0))

    def gn_step(st):
        si, sj = gather(st, i_idx), gather(st, j_idx)
        r_f = _imu_boxplus(x_imu, si, sj, imu_factors, g)
        J = imu_jac(x_imu, si, sj, imu_factors, g)  # (M,15,30)
        m = imu_mask[:, None, None]
        Ji, Jj = J[..., :15] * m, J[..., 15:] * m
        r_f = r_f * imu_mask[:, None]
        sp = gather(st, prior_idx)
        r_p = _prior_boxplus(x_prior, sp, prior_z, prior_sqrtw)
        Jp = prior_jac(x_prior, sp, prior_z, prior_sqrtw) * prior_mask[:, None, None]
        r_p = r_p * prior_mask[:, None]

        def matvec(x):  # (N,15)
            y = torch.einsum("mab,mb->ma", Ji, x[i_idx]) + torch.einsum("mab,mb->ma", Jj, x[j_idx])
            out = _segment_sum(torch.einsum("mab,ma->mb", Ji, y), i_idx, N) + _segment_sum(
                torch.einsum("mab,ma->mb", Jj, y), j_idx, N)
            yp = torch.einsum("kab,kb->ka", Jp, x[prior_idx])
            out = out + _segment_sum(torch.einsum("kab,ka->kb", Jp, yp), prior_idx, N)
            out = out + params.damping * x
            return torch.where(free[:, None], out, 0.0)

        grad = (_segment_sum(torch.einsum("mab,ma->mb", Ji, r_f), i_idx, N)
                + _segment_sum(torch.einsum("mab,ma->mb", Jj, r_f), j_idx, N)
                + _segment_sum(torch.einsum("kab,ka->kb", Jp, r_p), prior_idx, N))
        grad = torch.where(free[:, None], grad, 0.0)

        # block-Jacobi preconditioner (15×15 per state)
        M = (_segment_sum(torch.einsum("mab,mac->mbc", Ji, Ji), i_idx, N)
             + _segment_sum(torch.einsum("mab,mac->mbc", Jj, Jj), j_idx, N)
             + _segment_sum(torch.einsum("kab,kac->kbc", Jp, Jp), prior_idx, N)
             + (params.damping + 1e-6) * torch.eye(15, dtype=torch.float32, device=dev))
        Minv = torch.linalg.inv_ex(M).inverse

        def precond(x):
            return torch.where(free[:, None], torch.einsum("nab,nb->na", Minv, x), 0.0)

        x = torch.zeros_like(grad)
        rr = -grad
        zz = precond(rr)
        pp = zz
        rz = torch.sum(rr * zz)
        for _ in range(params.pcg_iters):
            Ap = matvec(pp)
            pAp = torch.sum(pp * Ap)
            alpha = rz / torch.where(torch.abs(pAp) > 1e-20, pAp, 1e-20)
            x = x + alpha * pp
            rr = rr - alpha * Ap
            zz = precond(rr)
            rz_new = torch.sum(rr * zz)
            beta = rz_new / torch.where(torch.abs(rz) > 1e-20, rz, 1e-20)
            pp = zz + beta * pp
            rz = rz_new
        pose, vel, ba, bg = _retract_one(st.pose, st.vel, st.ba, st.bg, x)
        f = free[:, None]
        new = LioStates(torch.where(f, pose, st.pose), torch.where(f, vel, st.vel),
                        torch.where(f, ba, st.ba), torch.where(f, bg, st.bg))
        dxn = torch.sqrt(torch.sum(x * x) / torch.clamp(torch.sum(free), min=1))
        return new, dxn < params.converged_dx

    chi2_0 = chi2_of(states)
    st = states
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(params.gn_iters):
        new, small = gn_step(st)
        # a converged state is frozen (the reference's scan runs on, masked)
        st = LioStates(*(torch.where(done, a, b) for a, b in zip(st, new)))
        done = done | small
    return st, PoseLioStats(chi2_0, chi2_of(st))


class FactorGraphLio:
    """Host wrapper: sliding LIO window with periodic reset + failure guard.

    States live on the host as float32 numpy (as in the reference); each
    ``add_scan`` uploads the padded window to ``device``, solves there and
    reads the solution back once."""

    def __init__(
        self,
        window: int = 32,
        params: LioGraphParams = LioGraphParams(),
        imu_sqrtw: np.ndarray | None = None,
        prior_sqrtw: np.ndarray | None = None,
        max_velocity: float = 30.0,
        max_bias: float = 1.0,
        device="cuda",
    ):
        self.window = window
        self.params = params
        self.device = torch.device(device)
        # whitening: [θ, v, p, ba, bg] and pose-prior [θ(3), t(3)]
        self.imu_sqrtw = (
            np.asarray(imu_sqrtw, np.float32) if imu_sqrtw is not None
            else np.concatenate([np.full(9, 1e2), np.full(6, 1e3)]).astype(np.float32)
        )
        self.prior_sqrtw = (
            np.asarray(prior_sqrtw, np.float32) if prior_sqrtw is not None
            else np.full(6, 1e2, np.float32)
        )
        self.max_velocity = max_velocity
        self.max_bias = max_bias
        self.resets = 0
        self.n = 0
        self.reset()

    def reset(self, keep_last: bool = False):
        if keep_last and self.n > 0:
            pose0 = self.poses[self.n - 1].copy()
            vel0 = self.vels[self.n - 1].copy()
        else:
            pose0 = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
            vel0 = np.zeros(3, np.float32)
        self.n = 1
        self.poses = np.tile(pose0, (self.window, 1)).astype(np.float32)
        self.vels = np.tile(vel0, (self.window, 1)).astype(np.float32)
        self.bas = np.zeros((self.window, 3), np.float32)
        self.bgs = np.zeros((self.window, 3), np.float32)
        self.factors: list[dict] = []
        self.priors: list[tuple[int, np.ndarray]] = [(0, pose0)]

    def _tensor(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def add_scan(self, pre: PreintegratedImu, lidar_pose: np.ndarray):
        """New state from a preintegrated IMU window + a lidar pose prior
        (the scan-to-map result). Solves the window; returns (pose, vel)."""
        if self.n >= self.window:
            # periodic reset, re-anchored at the latest state
            self.reset(keep_last=True)
        i = self.n - 1
        j = self.n
        # predicted init for the new state; it and the factor come down in one copy
        pre = PreintegratedImu(*(torch.as_tensor(v, dtype=torch.float32, device=self.device)
                                 for v in pre))
        pose_j, vel_j = predict_pose(self._tensor(self.poses[i]), self._tensor(self.vels[i]),
                                     pre, gravity=self.params.gravity)
        fields = [getattr(pre, k).reshape(-1) for k in FACTOR_FIELDS]
        packed = torch.cat([pose_j, vel_j] + fields).cpu().numpy()
        self.poses[j] = packed[:7]
        self.vels[j] = packed[7:10]
        self.bas[j] = self.bas[i]
        self.bgs[j] = self.bgs[i]
        self.n += 1
        factor, at = dict(ij=(i, j)), 10
        for k in FACTOR_FIELDS:
            size = int(np.prod(_FIELD_SHAPES[k], dtype=int))
            factor[k] = packed[at:at + size].reshape(_FIELD_SHAPES[k])
            at += size
        self.factors.append(factor)
        self.priors.append((j, np.asarray(lidar_pose, np.float32)))
        self._solve()
        if self._failed():
            self.resets += 1
            self.reset(keep_last=True)
        return self.poses[self.n - 1].copy(), self.vels[self.n - 1].copy()

    def _failed(self) -> bool:
        k = self.n - 1
        return bool(
            np.linalg.norm(self.vels[k]) > self.max_velocity
            or max(np.linalg.norm(self.bas[k]), np.linalg.norm(self.bgs[k])) > self.max_bias
        )

    def _solve(self):
        N = self.window
        M = max(len(self.factors), 1)
        K = max(len(self.priors), 1)
        # padded to powers of two, as the reference pads (so that both
        # packages sum the same terms)
        Mp = 1 << (M - 1).bit_length()
        Kp = 1 << (K - 1).bit_length()
        imu_factors = {}
        for k in FACTOR_FIELDS:
            out = np.zeros((Mp,) + _FIELD_SHAPES[k], np.float32)
            for m, f in enumerate(self.factors):
                out[m] = f[k]
            imu_factors[k] = out
        # identity delta for padded factors keeps their residuals harmless
        imu_factors["dq"][len(self.factors):, 0] = 1.0
        imu_factors["sqrtw"] = np.tile(self.imu_sqrtw, (Mp, 1))
        imu_ij = np.zeros((Mp, 2), np.int64)
        imu_mask = np.zeros(Mp, bool)
        for m, f in enumerate(self.factors):
            imu_ij[m] = f["ij"]
            imu_mask[m] = True
        prior_z = np.zeros((Kp, 7), np.float32)
        prior_z[:, 0] = 1.0
        prior_idx = np.zeros(Kp, np.int64)
        prior_mask = np.zeros(Kp, bool)
        for k, (idx, z) in enumerate(self.priors):
            prior_idx[k] = idx
            prior_z[k] = z
            prior_mask[k] = True
        smask = np.zeros(N, bool)
        smask[: self.n] = True
        t = self._tensor
        states = LioStates(t(self.poses), t(self.vels), t(self.bas), t(self.bgs))
        out, stats = optimize_lio_graph(
            states, t(smask), {k: t(v) for k, v in imu_factors.items()}, t(imu_ij),
            t(imu_mask), t(prior_z), t(prior_idx), t(np.tile(self.prior_sqrtw, (Kp, 1))),
            t(prior_mask), params=self.params,
        )
        packed = torch.cat(list(out), dim=1).cpu().numpy()  # one read-back
        self.poses = packed[:, :7].copy()
        self.vels = packed[:, 7:10].copy()
        self.bas = packed[:, 10:13].copy()
        self.bgs = packed[:, 13:16].copy()
        self.last_stats = stats
