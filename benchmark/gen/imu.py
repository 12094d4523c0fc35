"""Frozen IMU stream of a planar course (numpy), a copy of the port's
``datasets/city.py::make_city_imu`` generalised from the city's course to any
course that turns only about the vertical axis (circle, line, city), worked
from the course's own poses. Nothing of the program is imported.

Window k covers the interval that ends at scan k (frame 0 has none). Over it
the body rates come from the course: velocities by central differences of the
positions at scan times (one-sided at the course's ends), a constant linear
acceleration (v_k − v_{k−1}) / T and a constant yaw rate Δyaw / T, sampled at
the middle of each IMU step, in the body frame, gravity included, with white
noise added. Integrated without noise, the window reproduces the interval's
rotation exactly and its translation to trapezoid accuracy.

The one change from the original: the noise of window k is drawn from a
generator seeded by (seed, 3, k) alone, as a scan's range noise is, instead of
one generator running through the whole course; so window k does not depend
on which windows were drawn before it.
"""
from __future__ import annotations

import numpy as np


def course_rates(poses, scan_hz: float = 10.0):
    """(velocities (n,3), yaws (n,)) of course poses (n,7) ``[qw qx qy qz x
    y z]`` at scan times, float64."""
    course = np.asarray(poses, np.float64)
    yaw = np.unwrap(2.0 * np.arctan2(course[:, 3], course[:, 0]))
    v = np.gradient(course[:, 4:7], 1.0 / scan_hz, axis=0)
    return v, yaw


def imu_window(v, yaw, k: int, rng: np.random.Generator, scan_hz: float = 10.0,
               imu_hz: float = 100.0, g: float = 9.81, gyro_noise: float = 1e-3,
               acc_noise: float = 2e-2):
    """(gyro (M,3), acc (M,3), dts (M,)) float32 of the interval ending at
    scan k >= 1, from :func:`course_rates`; the noise is drawn from ``rng``,
    gyro first."""
    T = 1.0 / scan_hz
    sub = int(round(imu_hz / scan_hz))
    dt = 1.0 / imu_hz
    a_w = (v[k] - v[k - 1]) / T  # constant accel over [k-1, k)
    rate = (yaw[k] - yaw[k - 1]) / T
    gy = np.zeros((sub, 3))
    ac = np.zeros((sub, 3))
    for j in range(sub):
        yy = yaw[k - 1] + rate * (j + 0.5) * dt
        c, s = np.cos(yy), np.sin(yy)
        Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        gy[j] = Rz.T @ np.array([0.0, 0.0, rate])
        ac[j] = Rz.T @ (a_w + np.array([0.0, 0.0, g]))
    gy += rng.normal(0.0, gyro_noise, gy.shape)
    ac += rng.normal(0.0, acc_noise, ac.shape)
    return gy.astype(np.float32), ac.astype(np.float32), np.full(sub, dt, np.float32)


def initial_velocity(poses, scan_hz: float = 10.0):
    """The course's velocity at frame 0 in frame 0's body frame (float32):
    what a caller seeds the filter with, since the course starts moving
    (``scripts/evaluate_torch.py::run_city``)."""
    p = np.asarray(poses, np.float64)
    w, x, y, z = p[0, :4]
    # rotate the world-frame forward difference by the inverse of q0
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    return (R.T @ ((p[1, 4:7] - p[0, 4:7]) * scan_hz)).astype(np.float32)
