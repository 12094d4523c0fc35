"""The IMU-aided step's filter and deskew, plain PyTorch in the dtype of the
inputs (the reference passes float64); imports nothing of the program and no
JAX. Each part is what the port's docstrings state:

- :func:`propagate`: mid-point integration of the nominal state (position,
  velocity, attitude; biases held) over an IMU window, sample i to sample
  i + 1 (the last sample paired with itself), and the 15 × 15 error
  covariance of [δp δv δθ δba δbg] carried by the transition Fx with the
  process noise densities × dt (``estimator/eskf.py::eskf_predict``,
  ``eskf_run``);
- :func:`reset_if_failed`: a velocity over ``max_velocity`` or a bias over
  ``max_bias`` zeroes the velocity and both biases and restores the initial
  covariance, keeping the pose (``lio/lio_tracker.py``, LIO-SAM's failure
  detection);
- :func:`deskew`: a point captured at sweep time s is moved by exp((s − 1)·ξ),
  ξ = log of the sweep's motion, into the end-of-sweep frame
  (``ops/preprocess.py::deskew``);
- :func:`update_pose`: the 6-dim pose correction (position and the local
  angle error log(q⁻¹ ⊗ q_meas), H identity on δp and δθ), Joseph form, then
  error injection (``eskf.py::eskf_update_pose``); the caller keeps it only
  where the frame's solve was accepted.

A state is a dict of tensors ``p, v, q, ba, bg, cov``. Departures from the
port, none of which changes a result beyond rounding: the innovation
covariance is solved (``torch.linalg.solve``) rather than inverted; the
standard deviations are squared in the working dtype, not first rounded to
float32; the quaternion of the attitude step is normalised once, after the
step, and sign-canonicalised (w ≥ 0) as the port's is; the arithmetic is
float64 where the port's is float32.
"""
from __future__ import annotations

import torch

from . import se3

P0, V0, TH0, BA0, BG0 = 0, 3, 6, 9, 12
FIELDS = ("p", "v", "q", "ba", "bg", "cov")


def so3_exp_q(w):
    """Rotation vector (..., 3) → unit quaternion, w ≥ 0."""
    th2 = torch.sum(w * w, -1, keepdim=True)
    th = torch.sqrt(th2.clamp(min=1e-30))
    small = th2 < 1e-12
    k = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * th) / th)
    qw = torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th))
    return se3.qnorm(torch.cat([qw, k * w], -1))


def _blocks(values, like):
    return torch.cat([torch.full((3,), float(v), dtype=like.dtype, device=like.device)
                      for v in values])


def init_cov(cfg: dict, like):
    """The filter's initial covariance: the squared initial deviations."""
    return torch.diag(_blocks([cfg["init_pos_std"] ** 2, cfg["init_vel_std"] ** 2,
                               cfg["init_att_std"] ** 2, cfg["init_ba_std"] ** 2,
                               cfg["init_bg_std"] ** 2], like))


def predict(st: dict, g0, a0, g1, a1, dt, cfg: dict) -> dict:
    """One IMU step from the sample (g0, a0) to the sample (g1, a1)."""
    q, ba, bg = st["q"], st["ba"], st["bg"]
    w_mid = 0.5 * (g0 + g1) - bg
    q_full = se3.qmul(q, so3_exp_q(w_mid * dt))
    a_mid = 0.5 * (se3.qrot(q, a0 - ba) + se3.qrot(q_full, a1 - ba))
    a_mid = a_mid - torch.stack([a_mid.new_zeros(()), a_mid.new_zeros(()),
                                 a_mid.new_tensor(cfg["gravity"])])
    p = st["p"] + st["v"] * dt + 0.5 * a_mid * dt * dt
    v = st["v"] + a_mid * dt
    R = se3.qmat(q)
    a_b = 0.5 * (a0 + a1) - ba
    I3 = torch.eye(3, dtype=p.dtype, device=p.device)
    F = torch.eye(15, dtype=p.dtype, device=p.device)
    F[P0:P0 + 3, V0:V0 + 3] = I3 * dt
    F[V0:V0 + 3, TH0:TH0 + 3] = -R @ se3.skew(a_b) * dt
    F[V0:V0 + 3, BA0:BA0 + 3] = -R * dt
    F[TH0:TH0 + 3, TH0:TH0 + 3] = I3 - se3.skew(w_mid * dt)
    F[TH0:TH0 + 3, BG0:BG0 + 3] = -I3 * dt
    rates = _blocks([0.0, cfg["acc_noise"] ** 2, cfg["gyro_noise"] ** 2,
                     cfg["acc_bias_noise"] ** 2, cfg["gyro_bias_noise"] ** 2], p)
    cov = F @ st["cov"] @ F.T + torch.diag(rates * dt)
    return {"p": p, "v": v, "q": se3.qnorm(q_full), "ba": ba, "bg": bg, "cov": cov}


def propagate(st: dict, gyro, acc, dts, cfg: dict) -> dict:
    """The state carried over a window (gyro, acc (M,3), dts (M,))."""
    n = gyro.shape[0]
    for i in range(n):
        j = min(i + 1, n - 1)
        st = predict(st, gyro[i], acc[i], gyro[j], acc[j], dts[i], cfg)
    return st


def reset_if_failed(st: dict, lio: dict):
    """(state, failed): the failure reset where the velocity or a bias is
    beyond the limits."""
    n = torch.linalg.vector_norm
    failed = bool(n(st["v"]) > lio["max_velocity"]) or bool(
        max(n(st["ba"]), n(st["bg"])) > lio["max_bias"])
    if not failed:
        return st, False
    z = torch.zeros_like(st["v"])
    return dict(st, v=z, ba=z, bg=z, cov=init_cov(lio["eskf"], st["p"])), True


def pose_of(st: dict):
    """The filter's pose (7,) ``[q, p]``."""
    return torch.cat([se3.qnorm(st["q"]), st["p"]])


def deskew(xyz, mask, times, motion):
    """Points (N,3) of a sweep moved into its end frame; ``motion`` (7,) is
    the sweep's start-to-end pose increment, ``times`` (N,) in [0, 1)."""
    xi = se3.log(motion)
    per = se3.exp((times - 1.0)[:, None] * xi[None, :])  # (N,7)
    moved = se3.qrot(per[:, :4], xyz) + per[:, 4:]
    return torch.where(mask[:, None], moved, xyz)


def update_pose(st: dict, pose, pos_std: float, rot_std: float) -> dict:
    """Joseph-form 6-dim pose correction with error injection."""
    P = st["cov"]
    r = torch.cat([pose[4:] - st["p"], se3.so3_log(se3.qmul(se3.qconj(st["q"]), pose[:4]))])
    V = torch.diag(torch.cat([torch.full((3,), pos_std ** 2, dtype=P.dtype, device=P.device),
                              torch.full((3,), rot_std ** 2, dtype=P.dtype, device=P.device)]))
    H = torch.zeros(6, 15, dtype=P.dtype, device=P.device)
    H[0:3, P0:P0 + 3] = torch.eye(3, dtype=P.dtype, device=P.device)
    H[3:6, TH0:TH0 + 3] = torch.eye(3, dtype=P.dtype, device=P.device)
    S = H @ P @ H.T + V
    K = torch.linalg.solve(S, H @ P).T  # P Hᵀ S⁻¹ (P and S symmetric)
    dx = K @ r
    IKH = torch.eye(15, dtype=P.dtype, device=P.device) - K @ H
    cov = IKH @ P @ IKH.T + K @ V @ K.T
    return {"p": st["p"] + dx[P0:P0 + 3], "v": st["v"] + dx[V0:V0 + 3],
            "q": se3.qnorm(se3.qmul(st["q"], so3_exp_q(dx[TH0:TH0 + 3]))),
            "ba": st["ba"] + dx[BA0:BA0 + 3], "bg": st["bg"] + dx[BG0:BG0 + 3], "cov": cov}
