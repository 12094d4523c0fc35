"""The port's IMU preintegration (``lmsf_slam_tpu_torch.estimator.
preintegration``) against the reference (``lmsf_slam_tpu/estimator/
preintegration.py``) on ``tests/test_lio.py``'s analytic IMU windows, on the
CPU.

Tolerances: every field of a 10-sample window's delta (rotation, velocity,
position, covariance, the five bias Jacobians) to rtol 1e-5 with an absolute
floor of 1e-7; ``predict_pose`` and ``correct_bias`` likewise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.estimator import preintegration as jpre
from lmsf_slam_tpu_torch.estimator import preintegration as ppre
from lmsf_slam_tpu_torch.interop import preintegrated_from_numpy
from tests.test_lio import analytic_state, make_streams
from tests import torch_threads  # noqa: F401

RTOL, ATOL = 1e-5, 1e-7


def assert_pre(got, want, rtol=RTOL, atol=ATOL):
    for name in ppre.PreintegratedImu._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def both(gy, ac, dts, valid, bg, ba):
    want = jpre.preintegrate(jnp.asarray(gy), jnp.asarray(ac), jnp.asarray(dts),
                             jnp.asarray(valid), jnp.asarray(bg), jnp.asarray(ba))
    got = ppre.preintegrate(t(gy), t(ac), t(dts), torch.as_tensor(valid), t(bg), t(ba))
    return got, want


@pytest.mark.parametrize("window", [1, 3])
def test_preintegrate_matches_reference(window):
    _, imu = make_streams(5)
    gy, ac, dts = imu[window]
    rng = np.random.default_rng(window)
    bg = rng.normal(scale=0.01, size=3).astype(np.float32)
    ba = rng.normal(scale=0.05, size=3).astype(np.float32)
    got, want = both(gy, ac, dts, np.ones(len(gy), bool), bg, ba)
    assert_pre(got, want)


def test_padded_window_matches_reference():
    """Samples beyond the window's end are masked: they integrate with dt 0
    and give the delta of the valid samples."""
    _, imu = make_streams(3)
    gy, ac, dts = imu[1]
    pad = 6
    gyp = np.concatenate([gy, np.full((pad, 3), 5.0, np.float32)])
    acp = np.concatenate([ac, np.full((pad, 3), -3.0, np.float32)])
    dtp = np.concatenate([dts, np.full(pad, 0.01, np.float32)])
    valid = np.arange(len(gyp)) < len(gy)
    zero = np.zeros(3, np.float32)
    got, want = both(gyp, acp, dtp, valid, zero, zero)
    assert_pre(got, want)
    unpadded, _ = both(gy, ac, dts, np.ones(len(gy), bool), zero, zero)
    for name in ("dq", "dv", "dp", "dt"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(unpadded, name).numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_predict_pose_and_correct_bias_match_reference():
    poses, imu = make_streams(4)
    gy, ac, dts = imu[1]
    bg_true = np.array([0.02, -0.01, 0.03], np.float32)
    zero = np.zeros(3, np.float32)
    got, want = both(gy + bg_true, ac, dts, np.ones(len(gy), bool), zero, zero)
    _, v0, _, _, _ = analytic_state(0.1)
    wp, wv = jpre.predict_pose(jnp.asarray(poses[1]), jnp.asarray(v0, jnp.float32), want)
    gp, gv = ppre.predict_pose(t(poses[1]), t(v0), got)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=RTOL, atol=1e-6)
    dba = np.array([0.01, 0.0, -0.02], np.float32)
    assert_pre(ppre.correct_bias(got, t(bg_true), t(dba)),
               jpre.correct_bias(want, jnp.asarray(bg_true), jnp.asarray(dba)))
    # the reference's own claim, held by the port: the interval's motion
    err = np.linalg.norm(
        ppre.predict_pose(t(poses[1]), t(v0), both(gy, ac, dts, np.ones(len(gy), bool),
                                                   zero, zero)[0])[0].numpy()[4:] - poses[2][4:])
    assert err < 0.01
    # a reference delta carried over is the port's
    carried = preintegrated_from_numpy({k: np.asarray(v) for k, v in want._asdict().items()},
                                       device="cpu")
    assert_pre(carried, want, rtol=0, atol=0)
