"""Online hand-eye calibration: the configuration only.

Counterpart of ``lmsf_slam_tpu/calibration/handeye.py::HandEyeConfig``, which
``SystemConfig`` carries so that configurations move between the packages
unchanged. The solver itself belongs to the multi-LiDAR path, which the port
does not have yet: ``MultiLidarSystem`` rejects ``n_lidars > 1``.
"""
from __future__ import annotations

from typing import NamedTuple


class HandEyeConfig(NamedTuple):
    capacity: int = 300  # max stored pose pairs
    min_rot_angle: float = 0.05  # rad — pair must carry rotation signal
    screw_rot_tol: float = 0.02  # rad — |angle_A − angle_B| gate
    screw_trans_tol: float = 0.05  # m — |d_A − d_B| axis-projection gate
    degeneracy_gate: float = 0.25  # 2nd-smallest singular value floor
    min_pairs: int = 15
