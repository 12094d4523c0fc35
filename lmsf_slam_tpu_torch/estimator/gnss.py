"""GNSS coordinate conversion: WGS-84 LLA ↔ ECEF ↔ local ENU.

Counterpart of ``lmsf_slam_tpu/estimator/gnss.py`` (a copy: that module
imports no JAX, but importing it would run the reference package's
``__init__``): the first fix anchors a local East-North-Up frame; every
subsequent fix converts to meters in that frame.

Deliberately host-side numpy float64, not torch: geodetic coordinates need
~1e-9 relative precision (1 cm on Earth radius) that float32 device math
cannot carry (f32 latitude quantizes to ~0.4 m), and this is ingest
preprocessing at GNSS rate (≤10 Hz) — the filter consumes the resulting
local-frame meters as float32 tensors on its device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

# WGS-84
_A = 6378137.0  # semi-major axis (m)
_F = 1.0 / 298.257223563
_E2 = _F * (2.0 - _F)  # first eccentricity squared


def lla_to_ecef(lla) -> np.ndarray:
    """(..., 3) [lat°, lon°, alt m] → ECEF meters (float64)."""
    lla = np.asarray(lla, np.float64)
    lat = np.deg2rad(lla[..., 0])
    lon = np.deg2rad(lla[..., 1])
    alt = lla[..., 2]
    sl, cl = np.sin(lat), np.cos(lat)
    n = _A / np.sqrt(1.0 - _E2 * sl * sl)
    x = (n + alt) * cl * np.cos(lon)
    y = (n + alt) * cl * np.sin(lon)
    z = (n * (1.0 - _E2) + alt) * sl
    return np.stack([x, y, z], axis=-1)


def enu_rotation(ref_lla) -> np.ndarray:
    """(3, 3) ECEF→ENU rotation at the reference point."""
    ref_lla = np.asarray(ref_lla, np.float64)
    lat = np.deg2rad(ref_lla[0])
    lon = np.deg2rad(ref_lla[1])
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    return np.array(
        [
            [-so, co, 0.0],
            [-sl * co, -sl * so, cl],
            [cl * co, cl * so, sl],
        ]
    )


class EnuFrame(NamedTuple):
    """Local ENU anchor (the reference's LocalCartesian origin)."""

    ref_lla: np.ndarray  # (3,)
    ref_ecef: np.ndarray  # (3,)
    rot: np.ndarray  # (3,3) ECEF→ENU


def make_enu_frame(ref_lla) -> EnuFrame:
    ref_lla = np.asarray(ref_lla, np.float64)
    return EnuFrame(ref_lla, lla_to_ecef(ref_lla), enu_rotation(ref_lla))


def lla_to_enu(frame: EnuFrame, lla) -> np.ndarray:
    """(..., 3) LLA → local ENU meters (float32 result for the filter)."""
    ecef = lla_to_ecef(lla)
    enu = (ecef - frame.ref_ecef) @ frame.rot.T
    return enu.astype(np.float32)
