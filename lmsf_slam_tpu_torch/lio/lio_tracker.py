"""LiDAR-inertial odometry: ESKF-propagated prediction + deskew + scan-to-map.

Counterpart of ``lmsf_slam_tpu/lio/lio_tracker.py``. Per scan: the IMU
window since the previous scan propagates the ESKF (with the encoder's wheel
speed when given); a velocity or bias beyond the failure gate resets the
filter's velocity, biases and covariance; the feature points are deskewed
with the propagated motion; the tracker registers with the IMU prediction;
a solve the tracker accepted corrects the filter.

The reference reads back up to five times a scan (three norms for the
failure gate, ``solve_ok``, the pose). Here both branches are masked on the
card with the reference's numbers: the failure reset is a ``torch.where`` on
the norm test and the failure count a device counter; the pose correction is
computed every scan and kept where ``solve_ok``. ``process_scan`` therefore
reads nothing back: it returns the pose as a tensor, and the caller's one
read-back of the frame (``system/ml_system.py::_read_back``) carries it with
the frame's flags. The IMU window goes to the card in one copy. A window
without wheel speeds propagates in one launch (``eskf_propagate``, the
kernel ``csrc/eskf.cu`` on the card); one with them through ``eskf_run``,
whose loop does the wheel update after each prediction.

A ``timer`` (:class:`..utils.profiling.StageTimer`) records the step's
stages as spans: ``lio.propagate`` (the window's copy, the propagation, the
failure test and the masked reset), ``lio.deskew`` (both clouds),
``lio.register`` (``tracker_step`` with the prediction) and ``lio.correct``
(the pose correction and its selection). A scan without an IMU window
records neither of the first two.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..common import se3
from ..common.pointcloud import ATTR_TIME, PointBatch
from ..estimator.eskf import (
    EskfConfig,
    EskfState,
    _select,
    eskf_init_state,
    eskf_propagate,
    eskf_run,
    eskf_update_pose,
)
from ..ops.preprocess import deskew
from ..tracker.tracker import TrackerConfig, tracker_init, tracker_step


class LioConfig(NamedTuple):
    tracker: TrackerConfig = TrackerConfig()
    eskf: EskfConfig = EskfConfig()
    reg_pos_std: float = 0.05  # registration measurement noise
    reg_rot_std: float = 0.01
    wheel_std: float = 0.1  # encoder speed noise (LWIO)
    deskew_enabled: bool = True
    # failure detection (LIO-SAM failureDetection)
    max_velocity: float = 30.0
    max_bias: float = 1.0


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


class LioTracker:
    """IMU-aided scan-to-local-map odometry (host orchestration, no read-back).

    ``eskf``, ``tracker_state`` and ``prev_pose`` are tensors on ``device``;
    ``n_scans`` counts on the host; ``failures`` reads the device counter of
    failure resets (one read-back, when asked); ``timer`` records the step's
    spans (none without one)."""

    def __init__(self, config: LioConfig = LioConfig(), device="cuda", timer=None):
        self.config = config
        self.device = torch.device(device)
        self._span = timer if timer is not None else (lambda label: contextlib.nullcontext())
        self.tracker_state = tracker_init(config.tracker, self.device)
        self.eskf: EskfState = eskf_init_state(config.eskf, device=self.device)
        self._init_cov = self.eskf.cov
        self.prev_pose = se3.pose_identity(device=self.device)
        self.n_scans = 0
        self._failures = torch.zeros((), dtype=torch.int32, device=self.device)

    @property
    def failures(self) -> int:
        return int(self._failures)

    @failures.setter
    def failures(self, value: int):
        self._failures = torch.full((), int(value), dtype=torch.int32, device=self.device)

    def _propagate(self, gyro, acc, dts, wheel_speeds=None) -> EskfState:
        n = len(gyro)
        cols = [np.asarray(gyro, np.float32), np.asarray(acc, np.float32),
                np.asarray(dts, np.float32).reshape(n, 1)]
        if wheel_speeds is not None:
            cols.append(np.broadcast_to(np.asarray(wheel_speeds, np.float32), (n,)).reshape(n, 1))
        window = torch.as_tensor(np.concatenate(cols, axis=1), device=self.device)  # one copy
        if wheel_speeds is None:
            return eskf_propagate(self.eskf, window[:, 0:3], window[:, 3:6], window[:, 6],
                                  self.config.eskf)
        final, _ = eskf_run(
            self.eskf, window[:, 0:3], window[:, 3:6], window[:, 6], None, None,
            config=self.config.eskf, wheel_speed=window[:, 7], wheel_std=self.config.wheel_std,
        )
        return final

    def _failed(self, state: EskfState) -> torch.Tensor:
        """Reset guard on absurd velocity or bias, as a bool tensor."""
        cfg = self.config
        return (_norm(state.v) > cfg.max_velocity) | (
            torch.maximum(_norm(state.ba), _norm(state.bg)) > cfg.max_bias
        )

    def process_scan(
        self,
        edge: PointBatch,
        surf: PointBatch,
        timestamp: float,
        gyro: Optional[np.ndarray] = None,  # (M,3) IMU window since last scan
        acc: Optional[np.ndarray] = None,
        imu_dts: Optional[np.ndarray] = None,  # (M,)
        wheel_speeds: Optional[np.ndarray] = None,  # (M,) or scalar, m/s
    ):
        """One LIO step. Returns (pose (7,) tensor, TrackerOutput), with
        nothing read back.

        ``wheel_speeds``: optional encoder forward-speed samples aligned with
        the IMU window — the LWIO configuration (wheel velocity +
        non-holonomic constraints fused in the same propagation)."""
        cfg = self.config
        span = self._span
        prediction = None
        if self.n_scans > 0 and gyro is not None and len(gyro) > 0:
            with span("lio.propagate"):
                state = self._propagate(gyro, acc, imu_dts, wheel_speeds)
                # reset velocity/bias, keep pose (LIO-SAM resets its graph)
                failed = self._failed(state)
                zeros = torch.zeros_like(state.v)
                reset = state._replace(v=zeros, ba=zeros, bg=zeros, cov=self._init_cov)
                self.eskf = _select(failed, reset, state)
                self._failures = self._failures + failed.to(torch.int32)
                prediction = se3.make_pose(self.eskf.q, self.eskf.p)
            if cfg.deskew_enabled and edge.attr.shape[-1] > 0:
                with span("lio.deskew"):
                    motion = se3.pose_between(self.prev_pose, prediction)
                    edge = deskew(edge, edge.attr[:, ATTR_TIME], motion)
                    surf = deskew(surf, surf.attr[:, ATTR_TIME], motion)

        with span("lio.register"):
            self.tracker_state, out = tracker_step(
                self.tracker_state, edge, surf, timestamp, cfg.tracker, prediction=prediction,
            )
        # registration corrects the filter — but a solve the tracker's gates
        # rejected (out.pose fell back to the prediction) is not a
        # measurement: the update is kept only where solve_ok
        with span("lio.correct"):
            corrected = eskf_update_pose(self.eskf, out.pose, cfg.reg_pos_std, cfg.reg_rot_std)
            self.eskf = _select(out.solve_ok, corrected, self.eskf)
        self.prev_pose = out.pose
        self.n_scans += 1
        return out.pose, out
