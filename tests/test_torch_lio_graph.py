"""The port's LIO factor graph (``lmsf_slam_tpu_torch.backend.lio_graph``)
against the reference (``lmsf_slam_tpu/backend/lio_graph.py``) on
``tests/test_lio_graph.py``'s windows (``tests/test_lio.py``'s analytic IMU
stream with a constant gyro bias, lidar priors with mm/mrad noise), on the
CPU.

Tolerances: poses to 1e-4 m (and quaternion components to 1e-4),
velocities to 1e-3 m/s, gyro biases to 1e-4, accelerometer biases to 1e-3
relative (weakly observable in a window of 4 states: float32 round-off in
PCG moves them most), chi2 to 1e-3 relative above an
absolute floor of 1e-6 (a converged window's chi2 is float32 round-off). The
reference compiles one program for every padded window shape, ~7 s each on
the CPU, so every case runs on a window of 3 states (two shapes, a
periodic reset included).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.backend import lio_graph as jg
from lmsf_slam_tpu.estimator.preintegration import predict_pose as jpredict_pose
from lmsf_slam_tpu_torch.backend import lio_graph as pg
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.estimator.preintegration import preintegrate as ppreintegrate
from lmsf_slam_tpu_torch.interop import lio_states_from_numpy, preintegrated_from_numpy
from tests.test_lio import analytic_state, make_streams

BG_TRUE = np.array([0.02, -0.015, 0.03], np.float32)


def windows(n, seed=0):
    """Ground-truth poses, the biased IMU windows preintegrated (numpy
    leaves, fed to both packages; ``tests/test_torch_preintegration.py``
    holds the port's preintegration to the reference's) and noisy lidar
    priors."""
    poses, imu = make_streams(n + 1)
    rng = np.random.RandomState(seed)
    pres, priors = [], []
    for i in range(n):
        gy, ac, dts = imu[i]
        pre = ppreintegrate(torch.as_tensor(gy + BG_TRUE), torch.as_tensor(ac),
                            torch.as_tensor(dts), torch.ones(len(gy), dtype=torch.bool),
                            torch.zeros(3), torch.zeros(3))
        pres.append({k: v.numpy() for k, v in pre._asdict().items()})
        priors.append(se3np.pose_retract(poses[i + 1], rng.randn(6) * 0.001).astype(np.float32))
    return poses, pres, priors


def anchored(fg, poses):
    """Anchor a FactorGraphLio of either package at the true first state."""
    fg.poses[0] = poses[0]
    _, v0, _, _, _ = analytic_state(0.0)
    fg.vels[0] = v0
    fg.priors = [(0, poses[0].copy())]
    return fg


def assert_window(got, want, n):
    np.testing.assert_allclose(got.poses[:n], want.poses[:n], atol=1e-4)
    np.testing.assert_allclose(got.vels[:n], want.vels[:n], atol=1e-3)
    np.testing.assert_allclose(got.bas[:n], want.bas[:n], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.bgs[:n], want.bgs[:n], atol=1e-4)


def test_optimize_lio_graph_matches_reference():
    """A full window of 3 states (2 factors, 3 priors padded to 4) from
    predicted initial states: both wrappers hold the same host window and
    solve it once. The reference's states also reach the port through
    ``lio_states_from_numpy``."""
    n = 2
    poses, pres, priors = windows(n)
    ref = anchored(jg.FactorGraphLio(window=3), poses)
    for i, (pre, z) in enumerate(zip(pres, priors)):  # add_scan without the solves
        pj, vj = jpredict_pose(jnp.asarray(ref.poses[i]), jnp.asarray(ref.vels[i]),
                               jg.PreintegratedImu(**{k: jnp.asarray(v) for k, v in pre.items()}))
        ref.poses[i + 1], ref.vels[i + 1] = np.asarray(pj), np.asarray(vj)
        ref.factors.append(dict(ij=(i, i + 1), **{k: pre[k] for k in pg.FACTOR_FIELDS}))
        ref.priors.append((i + 1, z))
    ref.n = n + 1
    port = pg.FactorGraphLio(window=3, device="cpu")
    for name in ("poses", "vels", "bas", "bgs"):
        setattr(port, name, getattr(ref, name).copy())
    port.factors, port.priors, port.n = list(ref.factors), list(ref.priors), ref.n
    start = lio_states_from_numpy(dict(pose=ref.poses, vel=ref.vels, ba=ref.bas, bg=ref.bgs),
                                  device="cpu")
    np.testing.assert_array_equal(start.pose.numpy(), ref.poses)
    ref._solve()
    port._solve()
    assert_window(port, ref, ref.n)
    for g, w in zip(port.last_stats, ref.last_stats):
        assert float(g) == pytest.approx(float(w), rel=1e-3, abs=1e-6)
    assert float(port.last_stats.chi2_final) < 0.1 * float(port.last_stats.chi2_initial)
    zeros = pg.LioStates.zeros(3, device="cpu")
    assert zeros.pose.shape == (3, 7) and float(zeros.pose[:, 0].sum()) == 3.0


@pytest.mark.parametrize("case", ["window_reset", "failure_reset"])
def test_factor_graph_matches_reference(case):
    """The host wrappers add the same scans: a window of 3 states fills and
    is re-anchored at its latest state (the periodic reset), or an absurdly
    tight velocity gate resets the window after the solve (the failure
    reset). Every returned state and chi2 agree."""
    n = 3 if case == "window_reset" else 1
    poses, pres, priors = windows(n)
    kw = dict(window=3, max_velocity=0.01 if case == "failure_reset" else 30.0)
    ref = anchored(jg.FactorGraphLio(**kw), poses)
    port = anchored(pg.FactorGraphLio(device="cpu", **kw), poses)
    resets = []
    for pre, z in zip(pres, priors):
        jpre = jg.PreintegratedImu(**{k: jnp.asarray(v) for k, v in pre.items()})
        want = ref.add_scan(jpre, z)
        got = port.add_scan(preintegrated_from_numpy(pre, device="cpu"), z)
        np.testing.assert_allclose(got[0], want[0], atol=1e-4)
        np.testing.assert_allclose(got[1], want[1], atol=1e-3)
        assert port.n == ref.n
        assert_window(port, ref, port.n)
        for g, w in zip(port.last_stats, ref.last_stats):
            assert float(g) == pytest.approx(float(w), rel=1e-3, abs=1e-6)
        resets.append(port.resets)
    assert port.resets == ref.resets
    if case == "window_reset":
        assert port.resets == 0 and port.n < n  # re-anchored at least once
    else:
        assert resets[0] >= 1
