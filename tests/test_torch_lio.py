"""The port's LIO tracker (``lmsf_slam_tpu_torch.lio.LioTracker``) against
the reference (``lmsf_slam_tpu/lio/lio_tracker.py``) on the CPU, over the
first frames of ``tests/test_lio.py``'s aggressive sequence: motion-blurred
16 × 360 sweeps (``simulate_scan_moving``, made by the reference) and 100 Hz
IMU windows, the prediction-trust gate on as the system sets it.

The reference side runs in float64 (``jax.enable_x64``, its tracker state
and filter widened), as ``tests/test_torch_tracker.py`` does and for the
reason given there: its float32 registration is ill-conditioned on ring
scans. Per frame: pose within 1e-4 m and 1e-4 rad, ``map_updated``,
``solve_ok`` and the registration's counters identical; the filter's
position within 1e-4 m and velocity within 1e-3 m/s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.estimator import eskf_init_state as jeskf_init_state
from lmsf_slam_tpu.lio import LioConfig as JLioConfig
from lmsf_slam_tpu.lio import LioTracker as JLioTracker
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.interop import lio_tracker_from_numpy
from lmsf_slam_tpu_torch.lio import LioConfig, LioTracker
from lmsf_slam_tpu_torch.ops.registration import RegistrationParams as PRP
from lmsf_slam_tpu_torch.tracker import TrackerConfig as PTC
from tests.test_lio import SCAN_HZ, _featurize, _tracker_cfg, analytic_state, skewed_scans  # noqa: F401
from tests.test_torch_registration import to_port, widen
from tests.test_torch_tracker import assert_frame, widen_state
from tests import torch_threads  # noqa: F401

N_FRAMES = 4
HANDOVER = 2  # frames before the reference's state is carried over


def configs():
    """(reference, port) LioConfig: the test sequence's tracker with the
    prediction-trust gate the system turns on under IMU."""
    jtc = _tracker_cfg()._replace(pred_trust_k=0.3)
    d = jtc._asdict()
    d["registration"] = PRP(**jtc.registration._asdict())
    return JLioConfig(tracker=jtc), LioConfig(tracker=PTC(**d))


def anchor_velocity(poses):
    """The filter's initial velocity in the tracker's frame (anchored at the
    first scan's end pose), as ``tests/test_lio.py`` seeds it."""
    _, v1, _, _, _ = analytic_state(1 / SCAN_HZ)
    return se3np.quat_rotate(se3np.quat_conj(poses[1][:4].astype(np.float64)),
                             np.asarray(v1)).astype(np.float32)


def widen_eskf(eskf):
    with jax.enable_x64(True):
        return jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), eskf)


def imu_kw(window):
    return {} if window is None else dict(zip(("gyro", "acc", "imu_dts"), window))


@pytest.fixture(scope="module")
def reference_run(skewed_scans):  # noqa: F811
    """The reference's LIO tracker in float64 over the first frames: the
    features, IMU windows, per-frame outputs, and its state after
    ``HANDOVER`` frames (tracker state, filter, prev_pose, scan count) as
    float32 numpy, the dtype both packages keep."""
    _, poses, imu, scans = skewed_scans
    feats = [jax.tree.map(np.asarray, _featurize(scans[i])) for i in range(N_FRAMES)]
    windows = [None] + [imu[i] for i in range(1, N_FRAMES)]
    jcfg, _ = configs()
    va = anchor_velocity(poses)
    ref = JLioTracker(jcfg)
    ref.tracker_state = widen_state(ref.tracker_state)
    ref.eskf = widen_eskf(jeskf_init_state()._replace(v=jnp.asarray(va)))
    outs, filters, handed = [], [], None
    for i, ((edge, surf), window) in enumerate(zip(feats, windows)):
        if i == HANDOVER:
            handed = narrow((ref.tracker_state, ref.eskf, ref.prev_pose)) + (ref.n_scans,)
        with jax.enable_x64(True):
            _, out = ref.process_scan(*widen((edge, surf)), i / SCAN_HZ, **imu_kw(window))
        outs.append(jax.tree.map(np.asarray, out))
        filters.append(jax.tree.map(np.asarray, ref.eskf))
    assert ref.failures == 0
    return dict(feats=feats, windows=windows, va=va, outs=outs, filters=filters, handed=handed,
                prev_pose=np.asarray(ref.prev_pose))


def narrow(tree):
    """float64 → float32 and int64 → int32 numpy leaves."""
    def one(a):
        a = np.asarray(a)
        return a.astype({np.dtype(np.float64): np.float32,
                         np.dtype(np.int64): np.int32}.get(a.dtype, a.dtype))

    return jax.tree.map(one, tree)


def assert_filter(port, want):
    np.testing.assert_allclose(port.eskf.p.numpy(), want.p, atol=1e-4)
    np.testing.assert_allclose(port.eskf.v.numpy(), want.v, atol=1e-3)
    np.testing.assert_allclose(port.eskf.q.numpy(), want.q, atol=1e-4)


def run_port(port, run, frames):
    for i in frames:
        edge, surf = run["feats"][i]
        pose, got = port.process_scan(to_port(edge), to_port(surf), i / SCAN_HZ,
                                      **imu_kw(run["windows"][i]))
        assert pose is got.pose  # nothing read back: the pose stays a tensor
        assert_frame(got, run["outs"][i], i)
        assert_filter(port, run["filters"][i])


def test_lio_tracker_matches_reference(reference_run):
    _, pcfg = configs()
    port = LioTracker(pcfg, device="cpu")
    port.eskf = port.eskf._replace(v=torch.as_tensor(reference_run["va"]))
    run_port(port, reference_run, range(N_FRAMES))
    assert port.n_scans == N_FRAMES and port.failures == 0
    np.testing.assert_allclose(port.prev_pose.numpy(), reference_run["prev_pose"], atol=1e-4)


def test_resume_from_reference_lio_state(reference_run):
    """The reference's tracker after ``HANDOVER`` frames carried over with
    ``lio_tracker_from_numpy`` (tracker state, filter, prev_pose, scan
    count, rounded to float32), then the remaining frames in the port
    against the reference's own continuation."""
    _, pcfg = configs()
    tracker_state, eskf, prev_pose, n_scans = reference_run["handed"]
    port = lio_tracker_from_numpy(pcfg, tracker_state, eskf, prev_pose, n_scans, device="cpu")
    np.testing.assert_array_equal(port.eskf.cov.numpy(), eskf.cov)
    np.testing.assert_array_equal(port.prev_pose.numpy(), prev_pose)
    np.testing.assert_array_equal(port.tracker_state.edge_flat.xyz.numpy(),
                                  tracker_state.edge_flat.xyz)
    assert (port.n_scans, port.failures) == (HANDOVER, 0)
    run_port(port, reference_run, range(HANDOVER, N_FRAMES))


