"""Error-state Kalman filter (ESKF) for IMU(+GNSS, +wheel) inertial navigation.

Counterpart of ``lmsf_slam_tpu/estimator/eskf.py``:

- 15-dim error state [δp δv δθ δba δbg];
- mid-point IMU integration of nominal P/V/Q and the error covariance
  propagated with the Fx/Fi/Qi blocks (:func:`eskf_predict`);
- Joseph-form corrections with error injection: position (GNSS), body-frame
  velocity with non-holonomic constraints and a χ² slip gate (wheel), and
  the 6-dim pose of a scan-to-map registration;
- static initialization from a still window (:func:`static_initialize`).

The state is a NamedTuple of float32 tensors on one device. The reference
runs a whole log as one ``lax.scan``; here :func:`eskf_run` is a Python loop
over the samples that launches work and reads nothing back. A window without
corrections propagates through :func:`eskf_propagate`: on the card one
launch of the hand-written kernel ``csrc/eskf.cu`` (:func:`eskf_propagate_cuda`),
on the CPU :func:`eskf_run`'s loop. Every decision
the reference takes with ``jnp.where`` is a ``torch.where`` here, and the
3×3 and 6×6 innovation covariances are inverted with ``torch.linalg.inv_ex``,
which does not check its result on the host (``torch.linalg.inv`` would
synchronise with the card at every update). Constants are made on the
device (``eye``, ``zeros``, fills), never copied from host lists, since a
copy from pageable host memory waits for the card as well.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..common import se3

# error-state block offsets
P0, V0, TH0, BA0, BG0 = 0, 3, 6, 9, 12


class EskfConfig(NamedTuple):
    acc_noise: float = 1e-2  # m/s² /√Hz
    gyro_noise: float = 1e-3  # rad/s /√Hz
    acc_bias_noise: float = 1e-4  # random-walk densities
    gyro_bias_noise: float = 1e-5
    gravity: float = 9.81
    init_pos_std: float = 0.1
    init_vel_std: float = 0.1
    init_att_std: float = 0.05
    init_ba_std: float = 0.05
    init_bg_std: float = 0.01


class EskfState(NamedTuple):
    p: torch.Tensor  # (3,) position (nav frame)
    v: torch.Tensor  # (3,) velocity
    q: torch.Tensor  # (4,) body→nav rotation
    ba: torch.Tensor  # (3,) accelerometer bias
    bg: torch.Tensor  # (3,) gyro bias
    cov: torch.Tensor  # (15,15) error covariance


def _blocks(values, device) -> torch.Tensor:
    """(15,) float32 vector of five 3-blocks, each filled with one value."""
    return torch.cat([torch.full((3,), v, dtype=torch.float32, device=device) for v in values])


def eskf_init_state(config: EskfConfig = EskfConfig(), q0=None, device="cuda") -> EskfState:
    d = _blocks([config.init_pos_std**2, config.init_vel_std**2, config.init_att_std**2,
                 config.init_ba_std**2, config.init_bg_std**2], device)
    zeros = torch.zeros(3, dtype=torch.float32, device=device)
    return EskfState(
        p=zeros,
        v=zeros.clone(),
        q=se3.quat_identity(device=device) if q0 is None else q0,
        ba=zeros.clone(),
        bg=zeros.clone(),
        cov=torch.diag(d),
    )


def static_initialize(
    acc: torch.Tensor,  # (N,3) accelerometer samples while (supposedly) still
    gyro: torch.Tensor,  # (N,3)
    config: EskfConfig = EskfConfig(),
    still_acc_std: float = 0.1,
):
    """(state, is_still): gravity-aligned attitude + gyro bias from a static
    window. ``is_still`` is a bool tensor on the samples' device."""
    acc_mean = torch.mean(acc, dim=0)
    acc_std = torch.sqrt(torch.mean(torch.sum((acc - acc_mean) ** 2, -1)))
    is_still = acc_std < still_acc_std
    # rotation taking measured gravity direction to nav +z
    g_b = acc_mean / torch.clamp(torch.linalg.vector_norm(acc_mean), min=1e-9)
    z = torch.zeros_like(g_b)
    z[2] = 1.0
    axis = torch.linalg.cross(g_b, z)
    s = torch.linalg.vector_norm(axis)
    c = torch.dot(g_b, z)
    angle = torch.atan2(s, c)
    x_axis = torch.zeros_like(g_b)
    x_axis[0] = 1.0
    axis = torch.where(s > 1e-8, axis / torch.clamp(s, min=1e-9), x_axis)
    q0 = se3.so3_exp_quat(axis * angle)
    state = eskf_init_state(config, q0=q0, device=acc.device)
    return state._replace(bg=torch.mean(gyro, dim=0)), is_still


def _noise_rates(config: EskfConfig, device) -> torch.Tensor:
    """(15,) process-noise densities of [δp δv δθ δba δbg]; × dt gives Qi."""
    return _blocks([0.0, config.acc_noise**2, config.gyro_noise**2, config.acc_bias_noise**2,
                    config.gyro_bias_noise**2], device)


def eskf_predict(
    state: EskfState,
    gyro0: torch.Tensor, acc0: torch.Tensor,  # sample at t
    gyro1: torch.Tensor, acc1: torch.Tensor,  # sample at t+dt
    dt,
    config: EskfConfig = EskfConfig(),
    noise_rates: torch.Tensor | None = None,
) -> EskfState:
    """Mid-point nominal propagation + 15-dim covariance propagation.
    ``noise_rates``: ``_noise_rates(config, device)``, made once by a caller
    that predicts many times."""
    dev = state.p.device
    if noise_rates is None:
        noise_rates = _noise_rates(config, dev)
    w_mid = 0.5 * (gyro0 + gyro1) - state.bg
    # attitude: half-step rotations for the two accelerometer frames
    q_full = se3.quat_mul(state.q, se3.so3_exp_quat(w_mid * dt))
    a0_n = se3.quat_rotate(state.q, acc0 - state.ba)
    a1_n = se3.quat_rotate(q_full, acc1 - state.ba)
    a_mid = 0.5 * (a0_n + a1_n)
    a_mid[2] -= config.gravity  # + [0, 0, -g]
    p = state.p + state.v * dt + 0.5 * a_mid * dt * dt
    v = state.v + a_mid * dt

    # error-state transition Fx
    R = se3.quat_to_matrix(state.q)
    a_b = 0.5 * (acc0 + acc1) - state.ba
    I3 = torch.eye(3, dtype=torch.float32, device=dev)
    F = torch.eye(15, dtype=torch.float32, device=dev)
    F[P0:P0 + 3, V0:V0 + 3] = I3 * dt
    F[V0:V0 + 3, TH0:TH0 + 3] = -R @ se3.skew(a_b) * dt
    F[V0:V0 + 3, BA0:BA0 + 3] = -R * dt
    F[TH0:TH0 + 3, TH0:TH0 + 3] = I3 - se3.skew(w_mid * dt)
    F[TH0:TH0 + 3, BG0:BG0 + 3] = -I3 * dt
    cov = F @ state.cov @ F.T + torch.diag(noise_rates * dt)
    return EskfState(p, v, se3.quat_normalize(q_full), state.ba, state.bg, cov)


def _inv(S: torch.Tensor) -> torch.Tensor:
    """Inverse of a small innovation covariance without a host-side check."""
    return torch.linalg.inv_ex(S).inverse


def _inject(state: EskfState, dx: torch.Tensor, cov: torch.Tensor) -> EskfState:
    """Error injection into the nominal state."""
    return EskfState(
        p=state.p + dx[P0:P0 + 3],
        v=state.v + dx[V0:V0 + 3],
        q=se3.quat_normalize(se3.quat_mul(state.q, se3.so3_exp_quat(dx[TH0:TH0 + 3]))),
        ba=state.ba + dx[BA0:BA0 + 3],
        bg=state.bg + dx[BG0:BG0 + 3],
        cov=cov,
    )


def _select(cond: torch.Tensor, a: EskfState, b: EskfState) -> EskfState:
    """Field-wise ``where(cond, a, b)``."""
    return EskfState(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def _std2(std) -> torch.Tensor | float:
    """A standard deviation squared as the reference squares its float32
    scalar (a tensor stays a tensor)."""
    if isinstance(std, torch.Tensor):
        return std.to(torch.float32) ** 2
    return float(np.float32(std)) ** 2


def eskf_update_position(state: EskfState, pos: torch.Tensor, pos_std) -> EskfState:
    """Joseph-form position correction + error injection (H = [I₃ 0 …])."""
    P = state.cov
    dev = P.device
    V = torch.eye(3, dtype=torch.float32, device=dev) * _std2(pos_std)
    S = P[P0:P0 + 3, P0:P0 + 3] + V  # H P Hᵀ + V
    K = P[:, P0:P0 + 3] @ _inv(S)  # (15,3)
    r = pos - state.p
    dx = K @ r  # (15,)
    IKH = torch.eye(15, dtype=torch.float32, device=dev) - torch.nn.functional.pad(K, (0, 12))
    cov = IKH @ P @ IKH.T + K @ V @ K.T
    return _inject(state, dx, cov)


def eskf_update_wheel(
    state: EskfState,
    speed: torch.Tensor,  # scalar: signed forward wheel speed (body x), m/s
    speed_std,
    nhc_std=0.05,
    chi2_gate=16.27,  # χ²₃ @ 0.999
) -> EskfState:
    """Wheel-odometry velocity update with non-holonomic constraints.

    The measurement is the body-frame velocity, z = [speed, 0, 0]: the
    encoder gives forward speed, and a ground vehicle has (approximately)
    zero lateral/vertical body velocity. A χ² gate on the whitened residual
    rejects wheel slip / skid samples (branchless: the update is computed
    and masked). h(x) = Rᵀ v; ∂h/∂δv = Rᵀ, ∂h/∂δθ = skew(Rᵀ v).
    """
    dev = state.p.device
    R = se3.quat_to_matrix(state.q)
    vb = R.T @ state.v
    z = torch.zeros(3, dtype=torch.float32, device=dev)
    z[0] = speed
    r = z - vb  # (3,)
    H = torch.zeros((3, 15), dtype=torch.float32, device=dev)
    H[:, V0:V0 + 3] = R.T
    H[:, TH0:TH0 + 3] = se3.skew(vb)
    v = torch.ones(3, dtype=torch.float32, device=dev) * _std2(nhc_std)
    v[0] = _std2(speed_std)
    V = torch.diag(v)
    P = state.cov
    PHt = P @ H.T  # (15,3)
    S = H @ PHt + V
    Sinv = _inv(S)
    # slip rejection: Mahalanobis gate on the innovation
    ok = (r @ Sinv @ r) < chi2_gate
    K = PHt @ Sinv  # (15,3)
    dx = K @ r
    IKH = torch.eye(15, dtype=torch.float32, device=dev) - K @ H
    cov = IKH @ P @ IKH.T + K @ V @ K.T
    return _select(ok, _inject(state, dx, cov), state)


class EskfTrajectory(NamedTuple):
    p: torch.Tensor  # (N,3) position after each sample
    v: torch.Tensor  # (N,3)
    cov_diag: torch.Tensor  # (N,15)


def eskf_run(
    init: EskfState,
    gyro: torch.Tensor,  # (N,3)
    acc: torch.Tensor,  # (N,3)
    dt: torch.Tensor,  # (N,) step to the NEXT sample
    gnss_pos: torch.Tensor | None,  # (N,3) position measurement at sample i (nav/ENU)
    gnss_valid: torch.Tensor | None,  # (N,) bool
    gnss_std=0.05,
    config: EskfConfig = EskfConfig(),
    wheel_speed: torch.Tensor | None = None,  # (N,) forward wheel speed
    wheel_valid: torch.Tensor | None = None,  # (N,) bool
    wheel_std=0.1,
):
    """Whole-log filtering: per IMU sample predict (to the next sample) and,
    where ``gnss_valid``/``wheel_valid``, correct. Returns (final state,
    ``EskfTrajectory`` of the per-sample (p, v, cov diagonal)).

    ``gnss_valid=None`` (and ``gnss_pos=None``) says on the host that no
    sample carries a fix: the masked GNSS update is not computed. The
    reference computes it and throws it away, so the numbers are the same.
    ``wheel_valid=None`` with ``wheel_speed`` given means every sample is
    valid."""
    n = gyro.shape[0]
    g1 = torch.cat([gyro[1:], gyro[-1:]])
    a1 = torch.cat([acc[1:], acc[-1:]])
    rates = _noise_rates(config, gyro.device)
    state = init
    ps, vs, covs = [], [], []
    for i in range(n):
        state = eskf_predict(state, gyro[i], acc[i], g1[i], a1[i], dt[i], config, rates)
        if gnss_valid is not None:
            corrected = eskf_update_position(state, gnss_pos[i], gnss_std)
            state = _select(gnss_valid[i], corrected, state)
        if wheel_speed is not None:
            wheeled = eskf_update_wheel(state, wheel_speed[i], wheel_std)
            state = wheeled if wheel_valid is None else _select(wheel_valid[i], wheeled, state)
        ps.append(state.p)
        vs.append(state.v)
        covs.append(torch.diagonal(state.cov))
    return state, EskfTrajectory(torch.stack(ps), torch.stack(vs), torch.stack(covs))


_KERNEL = "eskf"
_PTR, _I64, _INT, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
_typed: set[str] = set()
_STATE_SHAPES = (("p", (3,)), ("v", (3,)), ("q", (4,)), ("ba", (3,)), ("bg", (3,)),
                 ("cov", (15, 15)))


def _library():
    """``csrc/eskf.cu`` built and loaded at first use, its entry point typed
    (an untyped pointer or 64-bit stride would be cut to 32 bits)."""
    lib = _build.load(_KERNEL)
    if _KERNEL in _typed:
        return lib
    with _build.lock:
        if _KERNEL not in _typed:
            fn = lib.eskf_propagate_launch
            fn.restype = _INT
            fn.argtypes = ([_PTR] * 6 + [_PTR, _I64, _I64, _PTR, _I64, _I64, _PTR, _I64, _INT]
                           + [_F32] * 6 + [_PTR] * 7)
            _typed.add(_KERNEL)
    return lib


def eskf_propagate_cuda(
    state: EskfState,
    gyro: torch.Tensor,
    acc: torch.Tensor,
    dt: torch.Tensor,
    config: EskfConfig = EskfConfig(),
) -> EskfState:
    """:func:`eskf_run`'s final state without corrections, as one launch of
    ``csrc/eskf.cu`` on the card: the window's samples read in place through
    their strides, the new state written into tensors allocated here. Nothing
    is read back, and no trajectory is kept."""
    dev = gyro.device
    if dev.type != "cuda":
        raise ValueError(f"the ESKF kernel needs CUDA tensors, got {dev}")
    n = gyro.shape[0]
    for name, x, shape in (("gyro", gyro, (n, 3)), ("acc", acc, (n, 3)), ("dt", dt, (n,)),
                           *((f, getattr(state, f), s) for f, s in _STATE_SHAPES)):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be a float32 {shape} tensor on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    src = [x.contiguous() for x in state]
    out = EskfState(*(torch.empty_like(x) for x in src))
    rates = (0.0, config.acc_noise**2, config.gyro_noise**2, config.acc_bias_noise**2,
             config.gyro_bias_noise**2)  # rounded to float32 as _noise_rates rounds them
    lib = _library()
    with _build.on_device(dev):
        rc = lib.eskf_propagate_launch(
            *(x.data_ptr() for x in src),
            gyro.data_ptr(), gyro.stride(0), gyro.stride(1),
            acc.data_ptr(), acc.stride(0), acc.stride(1), dt.data_ptr(), dt.stride(0), n,
            *rates, config.gravity, *(x.data_ptr() for x in out),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:  # -1: an empty window
        raise RuntimeError(f"ESKF kernel launch failed: CUDA error {rc}")
    _build.count_launch(_KERNEL)
    return out


def eskf_propagate(
    state: EskfState,
    gyro: torch.Tensor,  # (N,3), N >= 1
    acc: torch.Tensor,  # (N,3)
    dt: torch.Tensor,  # (N,) step to the NEXT sample
    config: EskfConfig = EskfConfig(),
    wheel_speed: torch.Tensor | None = None,
) -> EskfState:
    """The state after predicting through every sample of an IMU window, with
    no correction: CUDA tensors take the kernel (:func:`eskf_propagate_cuda`;
    it launches or raises, there is no fallback), CPU tensors :func:`eskf_run`.
    The kernel does no wheel update:
    a window with wheel speeds goes through :func:`eskf_run`, and
    ``wheel_speed`` given here raises."""
    if wheel_speed is not None:
        raise ValueError("eskf_propagate does no wheel update; eskf_run does")
    if gyro.shape[0] == 0:
        raise ValueError("an empty IMU window")
    if gyro.device.type == "cpu":
        return eskf_run(state, gyro, acc, dt, None, None, config=config)[0]
    return eskf_propagate_cuda(state, gyro, acc, dt, config)


def eskf_update_pose(
    state: EskfState,
    pose: torch.Tensor,  # (7,) measured pose (e.g. scan-to-map registration)
    pos_std,
    rot_std,
) -> EskfState:
    """6-dim pose correction (position + attitude) — the lidar-odometry
    update of a filter LIO. Rotation residual is the local angle error
    log(q⁻¹ ⊗ q_meas); H is identity on the δp and δθ blocks."""
    P = state.cov
    dev = P.device
    r = torch.cat([
        pose[4:] - state.p,
        se3.so3_log(se3.quat_mul(se3.quat_conj(state.q), pose[:4])),
    ])  # (6,)
    v = torch.cat([torch.full((3,), 1.0, dtype=torch.float32, device=dev) * _std2(pos_std),
                   torch.full((3,), 1.0, dtype=torch.float32, device=dev) * _std2(rot_std)])
    V = torch.diag(v)
    # H = [I3 0 0 ...; 0 0 I3 0 0] → PHᵀ = P[:, [0..2, 6..8]], S = H P Hᵀ + V
    PHt = torch.cat([P[:, P0:P0 + 3], P[:, TH0:TH0 + 3]], dim=1)  # (15,6)
    S = torch.cat([PHt[P0:P0 + 3], PHt[TH0:TH0 + 3]], dim=0) + V
    K = PHt @ _inv(S)  # (15,6)
    dx = K @ r
    H = torch.zeros((6, 15), dtype=torch.float32, device=dev)
    H[0:3, P0:P0 + 3] = torch.eye(3, dtype=torch.float32, device=dev)
    H[3:6, TH0:TH0 + 3] = torch.eye(3, dtype=torch.float32, device=dev)
    IKH = torch.eye(15, dtype=torch.float32, device=dev) - K @ H
    cov = IKH @ P @ IKH.T + K @ V @ K.T
    return _inject(state, dx, cov)
