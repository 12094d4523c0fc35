"""The port's ICP method of ``MultiLidarSystem`` over
``tests/test_system.py::test_system_sparse_point_plane_icp``'s 20 frames (its
``small_config``: 16 × 360 scans, ``icp_voxel_size=0.5``), with the port's
simulator on the CPU, held to that test's 0.25 m ATE bound.
``tests/test_torch_icp_system.py`` holds the same frames to the reference.
"""
import numpy as np

from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.evaluation import ate_stats
from lmsf_slam_tpu_torch.system import ml_system as psys
from tests import torch_threads  # noqa: F401
from tests.test_torch_icp_system import _port_scan, small_configs
from tests.test_torch_tracker import sim_course

N_FRAMES = 20  # tests/test_system.py's ICP run


def test_icp_system_tracks_the_course():
    """``tests/test_system.py``'s ICP run in the port: 20 frames, ATE under
    0.25 m."""
    traj, scans = sim_course(N_FRAMES, width=360)
    _, pcfg = small_configs()
    system = psys.MultiLidarSystem(pcfg, device="cpu")
    for i, scan in enumerate(scans):
        res = system.process(_port_scan(scan), 0.1 * i)
        assert np.isfinite(res.map_pose).all()
    est = system.trajectory()
    gt = se3np.pose_between(traj[:1], traj)
    assert ate_stats(est, gt).rmse < 0.25
    assert system.backend.db.n_keyframes > 5
    # the stored clouds are the ICP surf clouds; no edges
    assert system.backend.db.edge_mask[: system.backend.db.n_keyframes].sum() == 0
