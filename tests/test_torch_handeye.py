"""The port's hand-eye calibration (``lmsf_slam_tpu_torch.calibration``)
against the reference (``lmsf_slam_tpu/calibration/handeye.py``), function by
function, on the same numpy motion pairs: the four cases of
``tests/test_handeye.py``, each held to the reference test's own bounds too.

``handeye_add_pair``: the stores agree field by field after every pair (the
mask, write index and count exactly; the increments are copies). The solve
runs a float32 4×4 ``eigh`` and 3×3 ``solve`` in each package (LAPACK in
both, called differently): the extrinsic agrees to 1e-4 m and 1e-4 rad,
compared as a rotation (an eigenvector's sign is arbitrary, q ≡ −q), the
quality (a singular value) to 1e-3 relative or 1e-3 absolute (near zero it is
the square root of an eigenvalue at float32 rounding, ~1e-7·‖M‖), and ``ok``
exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.calibration import handeye as jhe
from lmsf_slam_tpu_torch.calibration import handeye as phe
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.interop import handeye_state_from_numpy
from tests import torch_threads  # noqa: F401


def make_motion_pairs(extrinsic, n, seed=21, noise=0.0, planar=False):
    """Primary increments A_i and sub increments B_i = X⁻¹ A_i X (float32)."""
    rng = np.random.default_rng(seed)
    inv_x = se3np.pose_inverse(extrinsic)
    pairs = []
    for _ in range(n):
        w = rng.uniform(-0.3, 0.3, 3)
        if planar:
            w[:2] = 0.0  # yaw-only rotation
        v = rng.uniform(-0.5, 0.5, 3)
        a = se3np.se3_exp(np.concatenate([w, v]))
        b = se3np.pose_compose(inv_x, se3np.pose_compose(a, extrinsic))
        if noise > 0:
            b = se3np.pose_retract(b, noise * rng.normal(size=6))
        pairs.append((np.float32(a), np.float32(b)))
    return pairs


def pose(w, t):
    return se3np.make_pose(se3np.so3_exp_quat(np.asarray(w, np.float64)), np.asarray(t))


def assert_same_store(p, j):
    for name in phe.HandEyeState._fields:
        got, want = getattr(p, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def rot_trans_err(a, b):
    d = se3np.pose_between(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return (float(np.linalg.norm(se3np.pose_trans(d))),
            float(np.linalg.norm(se3np.so3_log(se3np.pose_quat(d)))))


def run_both(pairs, cfg_kw=None):
    """Both packages over the same pairs, the stores compared after each;
    returns (port result, reference result)."""
    pcfg, jcfg = phe.HandEyeConfig(**(cfg_kw or {})), jhe.HandEyeConfig(**(cfg_kw or {}))
    ps, js = phe.handeye_init(pcfg, device="cpu"), jhe.handeye_init(jcfg)
    for a, b in pairs:
        ps = phe.handeye_add_pair(ps, torch.as_tensor(a), torch.as_tensor(b), pcfg)
        js = jhe.handeye_add_pair(js, jnp.asarray(a), jnp.asarray(b), jcfg)
        assert_same_store(ps, js)
    pr, jr = phe.handeye_solve(ps, pcfg), jhe.handeye_solve(js, jcfg)
    assert bool(pr.ok) == bool(jr.ok)
    np.testing.assert_allclose(float(pr.quality), float(jr.quality), rtol=1e-3, atol=1e-3)
    te, re = rot_trans_err(pr.extrinsic.numpy(), np.asarray(jr.extrinsic))
    if bool(jr.ok):
        assert te < 1e-4 and re < 1e-4, (te, re)
        np.testing.assert_allclose(float(pr.trans_residual), float(jr.trans_residual),
                                   rtol=1e-2, atol=1e-5)
    # the port solves the reference's own store the same way
    carried = phe.handeye_solve(handeye_state_from_numpy(
        {k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu"), pcfg)
    assert torch.equal(carried.extrinsic, pr.extrinsic) and bool(carried.ok) == bool(pr.ok)
    return pr, jr


def test_recovers_known_extrinsic_exact():
    x_true = pose([0.1, -0.2, 0.8], [0.5, -1.2, 0.3])
    res, _ = run_both(make_motion_pairs(x_true, 40))
    assert bool(res.ok)
    te, re = rot_trans_err(res.extrinsic.numpy(), x_true)
    assert te < 1e-4 and re < 1e-5, (te, re)


def test_recovers_extrinsic_under_noise():
    x_true = pose([0.0, 0.0, 1.57], [1.0, 0.0, 0.2])
    res, _ = run_both(make_motion_pairs(x_true, 120, noise=3e-3),
                      dict(screw_rot_tol=0.05, screw_trans_tol=0.1))
    assert bool(res.ok)
    te, re = rot_trans_err(res.extrinsic.numpy(), x_true)
    # < 1 cm translation, < 0.5° rotation
    assert te < 0.01 and re < np.deg2rad(0.5), (te, re)


def test_planar_motion_is_degenerate():
    """Yaw-only rotations leave the z-component unobservable — the
    degeneracy gate must refuse."""
    x_true = pose([0.05, 0.1, 0.3], [0.4, 0.1, 0.7])
    res, _ = run_both(make_motion_pairs(x_true, 60, planar=True))
    assert not bool(res.ok)
    assert float(res.quality) < 0.25


@pytest.mark.parametrize("which", ["mismatched", "tiny-rotation"])
def test_screw_check_rejects_mismatched_pairs(which):
    cfg = phe.HandEyeConfig()
    if which == "mismatched":
        # a pair whose rotations disagree: not a rigid-link motion
        a = se3np.se3_exp(np.array([0.0, 0.0, 0.3, 0.5, 0.0, 0.0]))
        b = se3np.se3_exp(np.array([0.0, 0.0, 0.1, 0.5, 0.0, 0.0]))
    else:
        # a tiny-rotation pair is rejected too (no signal)
        a = b = se3np.se3_exp(np.array([0, 0, 0.001, 0.5, 0, 0]))
    a, b = np.float32(a), np.float32(b)
    ps = phe.handeye_add_pair(phe.handeye_init(cfg, device="cpu"), torch.as_tensor(a),
                              torch.as_tensor(b), cfg)
    js = jhe.handeye_add_pair(jhe.handeye_init(jhe.HandEyeConfig()), jnp.asarray(a),
                              jnp.asarray(b), jhe.HandEyeConfig())
    assert_same_store(ps, js)
    assert int(torch.sum(ps.mask)) == 0 and int(ps.count) == 0 and int(ps.write_idx) == 0
