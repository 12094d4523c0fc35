"""The port's IMU-aided system (``MultiLidarSystem`` with ``use_imu=True``,
``process_gnss``) on the CPU, on ``tests/test_lio.py``'s aggressive
sequence: motion-blurred 16 × 360 sweeps and 100 Hz IMU windows.

- The whole ``use_imu`` frame in the reference's scenario
  (``tests/test_lio.py::test_system_with_imu``): the port holds the
  reference's own bounds over 25 frames (odometry within 0.25 m of the
  ground truth after frame 2, more than 3 keyframes);
  ``tests/test_torch_lio_keyframes.py`` holds its keyframe flags to the
  float32 reference system's over the first 8 frames.
- ``process_gnss``: the fix lands on the next keyframe as a graph prior
  (``tests/test_lio.py::test_system_gnss_prior_reaches_keyframe``), inline
  and through the worker thread.
- The failure reset and the wheel leg of ``LioTracker``, masked on the
  device: the numbers of the host branch the reference takes.
"""
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.backend import LoopConfig as JLoopConfig
from lmsf_slam_tpu.ops.registration import RegistrationParams as JRP
from lmsf_slam_tpu.system import FeatureParams as JFP
from lmsf_slam_tpu.system import SystemConfig as JSC
from lmsf_slam_tpu_torch.backend import LoopConfig
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch as PPB
from lmsf_slam_tpu_torch.estimator import eskf_init_state, eskf_run, eskf_update_pose
from lmsf_slam_tpu_torch.lio import LioConfig, LioTracker
from lmsf_slam_tpu_torch.ops.registration import RegistrationParams
from lmsf_slam_tpu_torch.system import FeatureParams, MultiLidarSystem, SystemConfig, tracker_config_for
from tests.test_lio import SCAN_HZ, analytic_state, skewed_scans  # noqa: F401

LLA = np.array([48.0, 11.0, 500.0])


def system_configs(**kw):
    """(reference, port) configuration of ``tests/test_lio.py``'s system."""
    common = {**dict(tracker_window=8, map_update_trans=0.15, keyframe_trans=0.5, use_imu=True), **kw}
    feat = dict(rings=16, width=360, edges_per_sector=4, surfs_per_sector=12)
    reg = dict(max_iters=8, max_corr_dist=2.0)
    return (JSC(feature=JFP(**feat), registration=JRP(**reg),
                loop=JLoopConfig(min_frame_interval=10**9), **common),
            SystemConfig(feature=FeatureParams(**feat), registration=RegistrationParams(**reg),
                         loop=LoopConfig(min_frame_interval=10**9), **common))


def anchor_velocity(gt0):
    _, v1, _, _, _ = analytic_state(1 / SCAN_HZ)
    return se3np.quat_rotate(se3np.quat_conj(gt0[:4].astype(np.float64)),
                             np.asarray(v1)).astype(np.float32)


def port_scan(pb):
    return PPB(*(torch.as_tensor(np.array(a)) for a in (pb.xyz, pb.mask, pb.attr)))


def imu_kw(imu, i):
    return {} if i == 0 else dict(zip(("gyro", "acc", "imu_dts"), imu[i]))


def run_port(scans, imu, n, gt0):
    """The port's ``use_imu`` system over the first ``n`` frames, its filter
    seeded as ``tests/test_lio.py`` seeds the reference's."""
    _, pcfg = system_configs()
    port = MultiLidarSystem(pcfg, device="cpu")
    port._lio.eskf = port._lio.eskf._replace(v=torch.as_tensor(anchor_velocity(gt0)))
    for i in range(n):
        port.process(port_scan(scans[i]), i / SCAN_HZ, **imu_kw(imu, i))
    return port


def test_system_with_imu_holds_the_reference_bounds(skewed_scans):  # noqa: F811
    """``tests/test_lio.py::test_system_with_imu``'s bounds over its 25
    frames: odometry within 0.25 m of the ground truth after frame 2, more
    than 3 keyframes (``tests/test_torch_lio_keyframes.py`` holds the
    keyframe flags to the reference's)."""
    _, poses, imu, scans = skewed_scans
    n = len(scans)
    gt = np.stack([poses[i + 1] for i in range(n)])
    gt_rel = se3np.pose_between(gt[0], gt)
    port = run_port(scans, imu, n, gt[0])
    assert port._lio.config.tracker.pred_trust_k == 0.3 and not port.tracker_config.deskew
    errs = [np.linalg.norm(se3np.pose_trans(se3np.pose_between(gt_rel[i], r.odom_pose)))
            for i, r in enumerate(port.results)]
    assert max(errs[2:]) < 0.25, errs
    assert port.backend.db.n_keyframes > 3
    assert port._lio.failures == 0


@pytest.mark.parametrize("async_backend", [False, True])
def test_gnss_prior_reaches_the_next_keyframe(skewed_scans, async_backend):  # noqa: F811
    """Every frame a keyframe; a fix between frames 0 and 1 anchors the ENU
    frame, corrects the filter, and rides keyframe 1 as a prior at the ENU
    origin (through the worker thread's queue with ``async_backend``)."""
    _, _, imu, scans = skewed_scans
    _, pcfg = system_configs(keyframe_trans=0.01, async_backend=async_backend)
    system = MultiLidarSystem(pcfg, device="cpu")
    system.process(port_scan(scans[0]), 0.0)
    before = system._lio.eskf.cov.clone()
    system.process_gnss(LLA)
    assert system._enu is not None and system._pending_gnss is not None
    assert float(system._lio.eskf.cov[0, 0]) < float(before[0, 0])  # the fix was fused
    system.process(port_scan(scans[1]), 0.1, **imu_kw(imu, 1))
    system.flush()
    db = system.backend.db
    assert db.n_keyframes == 2 and system._pending_gnss is None
    assert bool(db.gnss_valid[1]) and not bool(db.gnss_valid[0])
    assert np.linalg.norm(db.gnss_pos[1]) < 1e-3
    # a second fix is expressed in the first one's frame: 1e-3° north
    system.process_gnss(LLA + [1e-3, 0.0, 0.0])
    assert system._pending_gnss[1] == pytest.approx(111.2, abs=0.05)
    if async_backend:
        system._async.close()
    no_imu = MultiLidarSystem(pcfg._replace(use_imu=False, async_backend=False), device="cpu")
    with pytest.raises(ValueError, match="use_imu"):
        no_imu.process_gnss(LLA)


def test_failure_reset_and_wheel_leg_are_masked_on_the_device():
    """An absurd IMU window (40 m/s after 0.1 s) trips the failure gate: the
    propagated pose is kept, velocity, biases and covariance reset, the
    device counter counts it. Then the wheel leg runs in the same
    propagation: the filter equals ``eskf_run`` with the wheel samples (held
    to the reference in ``tests/test_torch_eskf.py``)."""
    _, pcfg = system_configs()
    lio = LioTracker(LioConfig(tracker=tracker_config_for(pcfg)._replace(pred_trust_k=0.3)),
                     device="cpu")
    n = 10
    gyro = np.zeros((n, 3), np.float32)
    acc = np.tile(np.array([400.0, 0, 9.81], np.float32), (n, 1))
    dts = np.full(n, 0.01, np.float32)
    edge, surf = PPB.empty(384, device="cpu"), PPB.empty(1152, device="cpu")
    lio.process_scan(edge, surf, 0.0)
    start = lio.eskf
    _, out = lio.process_scan(edge, surf, 0.1, gyro=gyro, acc=acc, imu_dts=dts)
    propagated, _ = eskf_run(start, *map(torch.as_tensor, (gyro, acc, dts)), None, None)
    assert float(torch.linalg.vector_norm(propagated.v)) > lio.config.max_velocity
    assert lio.failures == 1
    zeros = torch.zeros(3)
    want = propagated._replace(v=zeros, ba=zeros, bg=zeros, cov=eskf_init_state(device="cpu").cov)
    if bool(out.solve_ok):  # the registration then corrects the reset filter
        want = eskf_update_pose(want, out.pose, lio.config.reg_pos_std, lio.config.reg_rot_std)
    for got_, want_ in zip(lio.eskf, want):
        np.testing.assert_array_equal(got_.numpy(), want_.numpy())
    still = np.tile(np.array([0, 0, 9.81], np.float32), (n, 1))
    start = lio.eskf
    lio.process_scan(edge, surf, 0.2, gyro=gyro, acc=still, imu_dts=dts, wheel_speeds=0.3)
    want, _ = eskf_run(start, *map(torch.as_tensor, (gyro, still, dts)), None, None,
                       wheel_speed=torch.full((n,), 0.3), wheel_std=lio.config.wheel_std)
    assert lio.failures == 1
    np.testing.assert_array_equal(lio.eskf.v.numpy(), want.v.numpy())
    assert float(lio.eskf.v[0]) > 0.05  # the encoder pulled the velocity forward
