"""The plain filter of the reference (``reference/eskf.py``, float64) against
the port's ``estimator/eskf.py`` and ``lio/lio_tracker.py`` (float32) on
seeded windows: propagation, the failure reset, the pose update and deskew.
The port is held against the JAX package by the repo's own tests
(``tests/test_torch_eskf.py``, ``tests/test_torch_lio.py``)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import pytest
import torch

from benchmark.harness import LIO_DEFAULTS
from benchmark.reference import eskf as ref
from benchmark.reference import se3 as ref_se3

CFG = LIO_DEFAULTS["eskf"]


def _window(seed, n=10, turn=0.6, accel=2.0):
    """A seeded 100 Hz window: gravity plus a forward acceleration and a yaw
    rate, each with noise, and a small gyro and accelerometer offset."""
    rng = np.random.default_rng(seed)
    gyro = np.tile([0.01, -0.02, turn], (n, 1)) + rng.normal(0, 0.05, (n, 3))
    acc = np.tile([accel, 0.3, 9.81], (n, 1)) + rng.normal(0, 0.2, (n, 3))
    dts = np.full(n, 0.01) + rng.uniform(-1e-3, 1e-3, n)
    return [x.astype(np.float32) for x in (gyro, acc, dts)]


def _port_state(seed):
    from lmsf_slam_tpu_torch.common import se3
    from lmsf_slam_tpu_torch.estimator.eskf import EskfConfig, eskf_init_state

    rng = np.random.default_rng(seed + 1000)
    st = eskf_init_state(EskfConfig(), device="cpu")
    q = se3.so3_exp_quat(torch.as_tensor(rng.normal(0, 0.3, 3), dtype=torch.float32))
    a = torch.as_tensor(rng.normal(0, 0.1, (15, 15)), dtype=torch.float32)
    return st._replace(p=torch.as_tensor(rng.normal(0, 20, 3), dtype=torch.float32),
                       v=torch.as_tensor(rng.normal(0, 5, 3), dtype=torch.float32), q=q,
                       ba=torch.as_tensor(rng.normal(0, 0.02, 3), dtype=torch.float32),
                       bg=torch.as_tensor(rng.normal(0, 0.002, 3), dtype=torch.float32),
                       cov=st.cov + a @ a.T * 1e-3)


def _as64(st):
    return {k: getattr(st, k).double() for k in ref.FIELDS}


def _close(ours, theirs, p_tol, cov_rtol):
    for k in ("p", "v", "ba", "bg"):
        torch.testing.assert_close(ours[k], getattr(theirs, k).double(), rtol=0, atol=p_tol)
    dq = ref_se3.so3_log(ref_se3.qmul(ref_se3.qconj(ours["q"]), theirs.q.double()))
    assert float(torch.linalg.vector_norm(dq)) < 1e-5
    scale = float(torch.max(torch.abs(ours["cov"])))
    torch.testing.assert_close(ours["cov"], theirs.cov.double(), rtol=0, atol=cov_rtol * scale)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
def test_propagation_is_the_ports(seed):
    from lmsf_slam_tpu_torch.estimator.eskf import EskfConfig, eskf_run

    st = _port_state(seed)
    gyro, acc, dts = _window(seed)
    theirs, _ = eskf_run(st, *(torch.as_tensor(x) for x in (gyro, acc, dts)), None, None,
                         config=EskfConfig())
    ours = ref.propagate(_as64(st), *(torch.as_tensor(x, dtype=torch.float64)
                                      for x in (gyro, acc, dts)), CFG)
    # float32 against float64 over ten steps, at positions of tens of metres
    _close(ours, theirs, p_tol=2e-5, cov_rtol=1e-5)


@pytest.mark.parametrize("fast", [False, True])
def test_the_failure_reset_is_the_ports(fast):
    from lmsf_slam_tpu_torch.lio.lio_tracker import LioTracker

    lio = LioTracker(device="cpu")
    st = _port_state(3)._replace(v=torch.tensor([35.0 if fast else 12.0, 0.0, 0.0]))
    lio.eskf = st
    gyro, acc, dts = _window(3)
    failed_port = bool(lio._failed(lio._propagate(gyro, acc, dts)))
    ours, failed = ref.reset_if_failed(
        ref.propagate(_as64(st), *(torch.as_tensor(x, dtype=torch.float64)
                                   for x in (gyro, acc, dts)), CFG), LIO_DEFAULTS)
    assert failed == failed_port == fast
    if fast:
        assert float(torch.linalg.vector_norm(ours["v"])) == 0.0
        torch.testing.assert_close(ours["cov"], lio._init_cov.double(), rtol=1e-6, atol=0)
    # a bias over its limit resets too
    _, biased = ref.reset_if_failed(dict(_as64(st), v=torch.zeros(3, dtype=torch.float64),
                                         bg=torch.tensor([0.0, 1.5, 0.0], dtype=torch.float64)),
                                    LIO_DEFAULTS)
    assert biased


@pytest.mark.parametrize("seed", [0, 4, 2**31 + 9])
def test_the_pose_update_is_the_ports(seed):
    from lmsf_slam_tpu_torch.common import se3
    from lmsf_slam_tpu_torch.estimator.eskf import eskf_update_pose

    st = _port_state(seed)
    rng = np.random.default_rng(seed)
    meas = se3.pose_compose(se3.make_pose(st.q, st.p), se3.se3_exp(
        torch.as_tensor(rng.normal(0, 0.05, 6), dtype=torch.float32)))
    theirs = eskf_update_pose(st, meas, LIO_DEFAULTS["reg_pos_std"], LIO_DEFAULTS["reg_rot_std"])
    ours = ref.update_pose(_as64(st), meas.double(), LIO_DEFAULTS["reg_pos_std"],
                           LIO_DEFAULTS["reg_rot_std"])
    _close(ours, theirs, p_tol=2e-5, cov_rtol=1e-5)


def test_deskew_is_the_ports():
    from lmsf_slam_tpu_torch.common import se3
    from lmsf_slam_tpu_torch.common.pointcloud import PointBatch
    from lmsf_slam_tpu_torch.ops.preprocess import deskew

    rng = np.random.default_rng(11)
    xyz = torch.as_tensor(rng.normal(0, 15, (500, 3)), dtype=torch.float32)
    mask = torch.as_tensor(rng.uniform(size=500) > 0.2)
    t = torch.as_tensor(rng.uniform(size=500), dtype=torch.float32)
    motion = se3.se3_exp(torch.tensor([0.0, 0.01, 0.08, 0.9, 0.05, 0.0]))
    theirs = deskew(PointBatch(xyz, mask, t[:, None]), t, motion)
    ours = ref.deskew(xyz.double(), mask, t.double(), motion.double())
    torch.testing.assert_close(ours, theirs.xyz.double(), rtol=0, atol=2e-5)
    assert torch.equal(ours[~mask], xyz.double()[~mask])


def test_the_lio_constants_are_the_systems():
    """The check's copy of the IMU-aided step's constants (``LIO_DEFAULTS``)
    is what a system built with ``use_imu`` runs: the filter's noise,
    initial deviations and gravity, the registration's measurement noise,
    the failure reset's limits and the tracker's motion and prediction-trust
    gates, with the system's 0.3 prediction trust under an IMU."""
    from benchmark import sut
    from lmsf_slam_tpu_torch.system import MultiLidarSystem, SystemConfig

    system = MultiLidarSystem(SystemConfig(use_imu=True), device="cpu")
    lio = system._lio.config
    try:
        assert LIO_DEFAULTS["eskf"] == lio.eskf._asdict()
        for k in ("reg_pos_std", "reg_rot_std", "max_velocity", "max_bias"):
            assert LIO_DEFAULTS[k] == getattr(lio, k), k
        gates = LIO_DEFAULTS["gates"]
        assert gates == {k: getattr(lio.tracker, k) for k in gates}
        assert gates["pred_trust_k"] == 0.3 and system.tracker_config.pred_trust_k == 0.0
        assert system.tracker_config._replace(pred_trust_k=0.3) == lio.tracker
    finally:
        sut.close(system)
