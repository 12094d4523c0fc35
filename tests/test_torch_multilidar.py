"""The port's dual-LiDAR system on the CPU: online extrinsic calibration (the
3-phase FSM) and fused tracking, in the scenario of
``tests/test_multilidar.py`` held to that test's own bounds: phase 2 reached,
the extrinsic within 0.05 m / 2°, ATE under 0.3 m.

The scenario is the reference's: its world's sizes (extent 22 m, 10 boxes,
18 cylinders), its wavy 3-axis trajectory, its true extrinsic (30° yaw,
(0, −0.6, 0.3) m), its configuration (``dual_config``) and its 40 frames of
2 × 16 × 360 scans; the world and the scan noise come from the port's
simulator and a numpy seed. The float32 reference over the first frames of
the same scans is in ``tests/test_torch_multilidar_reference.py``.
"""
import numpy as np
import pytest

from lmsf_slam_tpu_torch.backend import LoopConfig
from lmsf_slam_tpu_torch.calibration import HandEyeConfig
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch
from lmsf_slam_tpu_torch.datasets import make_sim_world, simulate_scan
from lmsf_slam_tpu_torch.evaluation import ate_stats
from lmsf_slam_tpu_torch.ops.registration import RegistrationParams
from lmsf_slam_tpu_torch.system import FeatureParams, MultiLidarSystem, SystemConfig
from tests import torch_threads  # noqa: F401

N_FRAMES = 40
SEED = 33

# true extrinsic: sub lidar 0.6 m right, 0.3 m up, yawed 30°
X_TRUE = se3np.make_pose(se3np.so3_exp_quat(np.array([0.0, 0.0, np.deg2rad(30.0)])),
                         np.array([0.0, -0.6, 0.3])).astype(np.float32)


def wavy_trajectory(n):
    """Genuine 3-axis rotation so hand-eye is observable: slow sinusoidal
    roll/pitch riding on a yawing arc."""
    poses = [se3np.pose_identity()]
    for i in range(1, n):
        xi = np.array([0.10 * np.sin(0.7 * i), 0.10 * np.cos(1.1 * i), 0.12, 0.3, 0.0, 0.0])
        poses.append(se3np.pose_compose(poses[-1], se3np.se3_exp(xi)))
    base = se3np.make_pose(np.array([1.0, 0.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.4]))
    return np.stack([se3np.pose_compose(base, p) for p in poses]).astype(np.float32)


def dual_config(**kw):
    d = dict(
        n_lidars=2,
        feature=FeatureParams(rings=16, width=360, edges_per_sector=4, surfs_per_sector=12),
        tracker_window=8,
        registration=RegistrationParams(max_iters=8, max_corr_dist=2.0),
        map_update_trans=0.15,
        keyframe_trans=0.6,
        handeye=HandEyeConfig(min_pairs=6, min_rot_angle=0.06, screw_rot_tol=0.05,
                              screw_trans_tol=0.1),
        calib_refine_frames=12,
        loop=LoopConfig(min_frame_interval=10**9),
    )
    d.update(kw)
    return SystemConfig(**d)


def dual_scans(n, seed=SEED):
    """(trajectory, [(primary scan, sub scan)]) on the CPU: the sub sensor
    rides at ``X_TRUE`` in the primary's frame."""
    rng = np.random.default_rng(seed)
    world = make_sim_world(rng, extent=22.0, n_boxes=10, n_cylinders=18)
    traj = wavy_trajectory(n)
    scans = []
    for p0 in traj:
        p1 = np.float32(se3np.pose_compose(p0, X_TRUE))
        scans.append(tuple(
            simulate_scan(world, p, rng, rings=16, width=360, max_range=40.0, noise=0.01,
                          device="cpu") for p in (p0, p1)))
    return traj, scans


def extrinsic_error(x):
    d = se3np.pose_between(np.asarray(x, np.float64), X_TRUE)
    return (float(np.linalg.norm(se3np.pose_trans(d))),
            float(np.linalg.norm(se3np.so3_log(se3np.pose_quat(d)))))


@pytest.fixture(scope="module")
def dual_run():
    traj, scans = dual_scans(N_FRAMES)
    system = MultiLidarSystem(dual_config(), device="cpu")
    for i, pair in enumerate(scans):
        system.process(list(pair), 0.1 * i)
    return system, traj


def test_calibration_reaches_fused_phase(dual_run):
    system, _ = dual_run
    assert system.calib_status == 2, (system.calib_status, system.extrinsics)
    # the phases advance in order (a frame reports the status after its own
    # calibration step), and the frames after it carry both LiDARs
    status = [r.calib_status for r in system.results]
    assert status[0] == 0 and status == sorted(status) and set(status) == {0, 1, 2}
    matches = [r.num_matches for r in system.results]
    first = status.index(2)
    f = system.config.feature
    assert min(matches[first + 1:]) > max(matches[:first + 1])
    assert max(matches[:first + 1]) <= f.edge_capacity + f.surf_capacity


def test_extrinsic_accuracy(dual_run):
    system, _ = dual_run
    te, re = extrinsic_error(system.extrinsics[0])
    assert te < 0.05, f"extrinsic translation error {te:.3f} m"
    assert re < np.deg2rad(2.0), f"extrinsic rotation error {np.rad2deg(re):.2f} deg"


def test_fused_tracking_quality(dual_run):
    system, traj = dual_run
    gt = se3np.pose_between(traj[:1], traj)
    # the trajectory during phases 0/1 is primary odometry too, so the whole
    # run should track ground truth
    s = ate_stats(system.trajectory(), gt)
    assert s.rmse < 0.3, s
    # the keyframes store the fused capacity
    db = system.backend.db
    assert db.n_keyframes > 3 and db.surf_capacity == 2 * system.config.feature.surf_capacity


def test_wrong_scan_count_rejected(dual_run):
    system, _ = dual_run
    with pytest.raises(ValueError, match="expected 2 scans"):
        system.process(PointBatch.empty(8, device="cpu"), 100.0)


def test_imu_aided_split_path_runs_with_two_lidars():
    """Under ``use_imu`` the two LiDARs take the split path through the
    ``LioTracker``, sized for the fused stream, while the calibration runs
    beside it on the primary's pose (the reference's ``process`` at
    ``ml_system.py:519-534``; its constructor asserts one LiDAR under IMU)."""
    traj, scans = dual_scans(3)
    system = MultiLidarSystem(dual_config(use_imu=True), device="cpu")
    assert system._lio.config.tracker.surf_capacity == 2 * system.config.feature.surf_capacity
    for i, pair in enumerate(scans):
        res = system.process(list(pair), 0.1 * i)
        assert res.calib_status == 0 and np.isfinite(res.odom_pose).all()
    assert system._anchors[0] is not None and system._lio.n_scans == 3
    gt = se3np.pose_between(traj[:1], traj)
    assert np.linalg.norm(system.trajectory()[:, 4:] - gt[:, 4:], axis=1).max() < 0.1
