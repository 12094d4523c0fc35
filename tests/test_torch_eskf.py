"""The port's ESKF (``lmsf_slam_tpu_torch.estimator.eskf``) against the
reference (``lmsf_slam_tpu/estimator/eskf.py``) on the same numpy inputs,
made from seeds, on the CPU.

Tolerances: one step (predict, the three corrections) to rtol 1e-5 with an
absolute floor of 1e-7 (float32 products summed in another order by another
BLAS); a 1000-sample run (``tests/test_lio.py``'s wheel scenario) to 1e-3 m
in position and 1e-3 m/s in velocity, with GNSS fixes every 10th sample to
rtol 1e-3 / atol 1e-4; the χ² slip gate takes the same decision on both
sides of its threshold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.estimator import eskf as je
from lmsf_slam_tpu_torch.estimator import eskf as pe
from tests import torch_threads  # noqa: F401

RTOL, ATOL = 1e-5, 1e-7
G = 9.81


def random_state(seed):
    """An ESKF state as numpy float32: a unit quaternion, a few m/s, small
    biases, an SPD covariance."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q = q / np.linalg.norm(q) * np.sign(q[0])
    A = rng.normal(scale=0.05, size=(15, 15))
    cov = A @ A.T + 1e-3 * np.eye(15)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(p=f(rng.normal(size=3)), v=f(rng.normal(scale=2.0, size=3)), q=f(q),
                ba=f(rng.normal(scale=0.05, size=3)), bg=f(rng.normal(scale=0.01, size=3)),
                cov=f(cov))


def both(state):
    """(reference EskfState, port EskfState) of one numpy state."""
    return (je.EskfState(**{k: jnp.asarray(v) for k, v in state.items()}),
            pe.EskfState(**{k: torch.as_tensor(v) for k, v in state.items()}))


def assert_state(got, want, rtol=RTOL, atol=ATOL):
    for name in pe.EskfState._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_predict_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    js, ps = both(random_state(seed))
    g0, g1 = rng.normal(scale=0.3, size=(2, 3)).astype(np.float32)
    a0, a1 = (rng.normal(scale=1.0, size=(2, 3)) + [0, 0, G]).astype(np.float32)
    dt = np.float32(0.01)
    cfg = je.EskfConfig(acc_noise=0.02, gyro_noise=0.002)
    want = je.eskf_predict(js, *map(jnp.asarray, (g0, a0, g1, a1, dt)), config=cfg)
    got = pe.eskf_predict(ps, t(g0), t(a0), t(g1), t(a1), t(dt), pe.EskfConfig(**cfg._asdict()))
    assert_state(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_position_and_pose_updates_match_reference(seed):
    rng = np.random.default_rng(200 + seed)
    state = random_state(seed)
    js, ps = both(state)
    pos = (state["p"] + rng.normal(scale=0.2, size=3)).astype(np.float32)
    want = je.eskf_update_position(js, jnp.asarray(pos), jnp.float32(0.05))
    assert_state(pe.eskf_update_position(ps, t(pos), 0.05), want)
    dq = np.concatenate([[1.0], rng.normal(scale=0.02, size=3)])
    meas = np.concatenate([state["q"], state["p"] + rng.normal(scale=0.1, size=3)])
    meas[:4] = np.asarray(je.se3.quat_mul(jnp.asarray(state["q"]),
                                           jnp.asarray(dq / np.linalg.norm(dq), jnp.float32)))
    meas = meas.astype(np.float32)
    want = je.eskf_update_pose(js, jnp.asarray(meas), jnp.float32(0.05), jnp.float32(0.01))
    assert_state(pe.eskf_update_pose(ps, t(meas), 0.05, 0.01), want)


@pytest.mark.parametrize("speed, accepted", [(None, True), (15.0, False)])
def test_wheel_update_matches_reference_on_both_sides_of_its_gate(speed, accepted):
    """A plausible encoder speed is taken; a slipping wheel's 15 m/s is
    rejected by the χ² gate: the state passes through unchanged."""
    state = random_state(7)
    R = np.asarray(je.se3.quat_to_matrix(jnp.asarray(state["q"])))
    state["v"] = (R @ [2.0, 0.01, -0.01]).astype(np.float32)  # driving forward
    speed = np.float32(2.05 if speed is None else speed)
    js, ps = both(state)
    want = je.eskf_update_wheel(js, jnp.asarray(speed), jnp.float32(0.1))
    got = pe.eskf_update_wheel(ps, t(speed), 0.1)
    assert_state(got, want)
    changed = not np.array_equal(got.cov.numpy(), state["cov"])
    assert changed == accepted


def wheel_scenario(n=1000, dt=0.01):
    """``tests/test_lio.py``'s straight drive at 2 m/s with gyro and
    accelerometer biases."""
    gyro = np.tile(np.array([0, 0, 0.002], np.float32), (n, 1))
    acc = np.tile(np.array([0.15, 0, G + 0.05], np.float32), (n, 1))
    return gyro, acc, np.full(n, dt, np.float32)


@pytest.mark.parametrize("wheel", ["none", "clean", "slip"])
def test_run_matches_reference_over_1000_samples(wheel):
    n = 1000
    gyro, acc, dts = wheel_scenario(n)
    init = dict(random_state(0))
    init.update(p=np.zeros(3, np.float32), v=np.array([2.0, 0, 0], np.float32),
                q=np.array([1, 0, 0, 0], np.float32), ba=np.zeros(3, np.float32),
                bg=np.zeros(3, np.float32),
                cov=np.array(je.eskf_init_state().cov))
    js, ps = both(init)
    kw_j, kw_p = {}, {}
    if wheel != "none":
        ws = np.full(n, 2.0, np.float32)
        if wheel == "slip":
            ws[::10] = 15.0
        kw_j = dict(wheel_speed=jnp.asarray(ws), wheel_valid=jnp.ones(n, bool), wheel_std=0.05)
        kw_p = dict(wheel_speed=t(ws), wheel_valid=torch.ones(n, dtype=torch.bool), wheel_std=0.05)
    want, wtraj = je.eskf_run(js, jnp.asarray(gyro), jnp.asarray(acc), jnp.asarray(dts),
                              jnp.zeros((n, 3)), jnp.zeros(n, bool), **kw_j)
    got, gtraj = pe.eskf_run(ps, t(gyro), t(acc), t(dts), None, None, **kw_p)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), atol=1e-3)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=1e-3)
    np.testing.assert_allclose(gtraj.p.numpy(), np.asarray(wtraj[0]), atol=1e-3)
    np.testing.assert_allclose(gtraj.cov_diag.numpy(), np.asarray(wtraj[2]), rtol=1e-3, atol=1e-9)
    if wheel != "none":  # the wheel leg bounds the biases' drift, slip or not
        assert np.linalg.norm(got.p.numpy() - [2.0 * n * 0.01, 0.0, 0.0]) < 0.5


def test_run_with_gnss_fixes_matches_reference():
    """Fixes at 10 Hz on a circle: the masked position update (computed
    where the mask is set) equals the reference's; ``gnss_valid=None`` is the
    same as an all-False mask."""
    n = 300
    rng = np.random.default_rng(3)
    dt = 0.01
    s = np.arange(n) * dt
    p = np.stack([5 * np.cos(s), 5 * np.sin(s), np.zeros(n)], 1)
    gyro = (np.array([0, 0, 1.0]) + 0.002 * rng.normal(size=(n, 3))).astype(np.float32)
    acc = (np.array([-5.0, 0, G]) + 0.02 * rng.normal(size=(n, 3))).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[::10] = True
    fix = (p + 0.03 * rng.normal(size=(n, 3))).astype(np.float32)
    init = dict(p=p[0].astype(np.float32), v=np.array([0, 5.0, 0], np.float32),
                q=np.array([np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)], np.float32),
                ba=np.zeros(3, np.float32), bg=np.zeros(3, np.float32),
                cov=np.array(je.eskf_init_state().cov))
    js, ps = both(init)
    dts = np.full(n, dt, np.float32)
    want, _ = je.eskf_run(js, jnp.asarray(gyro), jnp.asarray(acc), jnp.asarray(dts),
                          jnp.asarray(fix), jnp.asarray(valid), gnss_std=0.05)
    got, _ = pe.eskf_run(ps, t(gyro), t(acc), t(dts), t(fix), torch.as_tensor(valid), gnss_std=0.05)
    assert_state(got, want, rtol=1e-3, atol=1e-4)
    want0, _ = je.eskf_run(js, jnp.asarray(gyro), jnp.asarray(acc), jnp.asarray(dts),
                           jnp.asarray(fix), jnp.zeros(n, bool))
    got0, _ = pe.eskf_run(ps, t(gyro), t(acc), t(dts), None, None)
    assert_state(got0, want0, rtol=1e-3, atol=1e-4)


def test_init_and_static_initialization_match_reference():
    cfg = je.EskfConfig(init_pos_std=0.3)
    want, got = je.eskf_init_state(cfg), pe.eskf_init_state(pe.EskfConfig(**cfg._asdict()),
                                                             device="cpu")
    for name in pe.EskfState._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    rng = np.random.RandomState(2)  # tests/test_eskf.py's tilted static window
    q_true = je.se3.so3_exp_quat(jnp.asarray([np.deg2rad(10.0), 0.0, 0.0]))
    R = np.asarray(je.se3.quat_to_matrix(q_true))
    bg = np.array([0.01, -0.005, 0.002])
    acc = ((R.T @ np.array([0, 0, G]))[None, :] + 0.01 * rng.randn(200, 3)).astype(np.float32)
    gyro = (bg[None, :] + 0.001 * rng.randn(200, 3)).astype(np.float32)
    for a in (acc, acc + np.linspace(0, 5, 200, dtype=np.float32)[:, None]):
        ws, wstill = je.static_initialize(jnp.asarray(a), jnp.asarray(gyro))
        gs, gstill = pe.static_initialize(t(a), t(gyro))
        assert bool(gstill) == bool(wstill)
        assert_state(gs, ws, rtol=1e-5, atol=1e-6)
    assert bool(pe.static_initialize(t(acc), t(gyro))[1])
