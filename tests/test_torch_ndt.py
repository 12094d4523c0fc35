"""The port's NDT (``ops/voxel.py::voxel_gaussians``, ``voxel_lookup``,
``voxel_lookup7`` and ``ops/registration.py::register_ndt``) against the
reference on the same numpy inputs, on the CPU.

``voxel_gaussians``: counts, means, keys and valid equal; covariances to
float32 rounding (atol 1e-6: the same float32 formulas, which XLA may fuse
into other roundings); on ``tests/test_voxel.py``'s inputs and on clouds
with more occupied voxels than ``max_voxels`` (the reference's segment_sum
drops those segments, so the port must drop exactly the same voxels). The
lookups: slots and found flags exactly equal.

``register_ndt`` on ``tests/test_registration.py::test_ndt_registration``'s
room: the reference evaluated in float64 (``jax.enable_x64``, as the port's
other registration tests do); pose within 1e-4 m / 1e-4 rad, iterations and
``n_constrained`` equal, and the reference test's own bounds (0.1 m, 0.05
rad) against the true pose.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.common import se3 as jse3
from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
from lmsf_slam_tpu.ops import registration as jr
from lmsf_slam_tpu.ops import voxel as jv
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.ops import registration as pr
from lmsf_slam_tpu_torch.ops import voxel as pv
from tests import torch_threads  # noqa: F401
from tests.test_registration import make_pose, room_features
from tests.test_torch_registration import reference_f64, to_port


def _cluster():
    rng = np.random.RandomState(1)
    return (rng.randn(200, 3) * 0.05 + np.array([1.0, 3.0, 3.0])).astype(np.float32), 256, 2.0, 16


def _lookup_pts():
    return np.array([[0.1, 0.1, 0.1]] * 5 + [[3.0, 3.0, 3.0]] * 5, np.float32), 16, 1.0, 8


def _overflow(seed, n, extent, vs, cap):
    """A cloud spread over many more occupied voxels than ``cap``, off the
    origin so that its centroid is far from a lattice boundary."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32) + np.float32([31.3, -12.6, 4.2])
    return pts, n + 37, vs, cap


CLOUDS = {
    "cluster": _cluster,
    "lookup": _lookup_pts,
    "two clusters": lambda: (np.array([[0.01, 0.01, 0.01], [0.02, 0.0, 0.0], [5.0, 5.0, 5.0],
                                       [5.01, 5.0, 5.0]], np.float32), 8, 0.5, 8),
    "overflow 2000 pts in 256 voxels": lambda: _overflow(0, 2000, 8.0, 1.0, 256),
    "overflow dense 6000 pts in 1024 voxels": lambda: _overflow(1, 6000, 4.0, 0.7, 1024),
}


def _both(name):
    pts, cap, vs, V = CLOUDS[name]()
    jpb = JPB.from_points(pts, capacity=cap)
    return (jv.voxel_gaussians(jpb, voxel_size=vs, max_voxels=V),
            pv.voxel_gaussians(to_port(jpb), vs, V), pts)


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_voxel_gaussians_match_reference(name):
    want, got, pts = _both(name)
    assert set(got) == set(want)
    for k in ("counts", "means", "keys", "valid", "origin", "voxel_size"):
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    np.testing.assert_allclose(got["covs"].numpy(), np.asarray(want["covs"]), atol=1e-6, rtol=0)
    if name.startswith("overflow"):
        # more voxels were occupied than kept: every slot is filled and the
        # kept voxels are the ones with the smallest keys
        keys = got["keys"].numpy()
        assert np.all(keys < 2**31 - 1) and np.all(np.diff(keys) > 0)
        assert got["counts"].numpy().sum() < pts.shape[0]


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_voxel_lookups_match_reference(name):
    want, got, pts = _both(name)
    rng = np.random.default_rng(7)
    # the cloud's own points, points near them, and points far away
    q = np.concatenate([pts[:300], pts[:300] + rng.normal(0, 0.6, (min(300, len(pts)), 3)),
                        rng.uniform(-60, 60, (50, 3))]).astype(np.float32)
    for jfn, pfn in ((jv.voxel_lookup, pv.voxel_lookup), (jv.voxel_lookup7, pv.voxel_lookup7)):
        ws, wf = jfn(want, jnp.asarray(q))
        gs, gf = pfn(got, torch.as_tensor(q))
        assert gs.dtype == torch.int32
        np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        assert gf.numpy().any() == bool(got["valid"].any())


@pytest.fixture(scope="module")
def room():
    pb, _ = room_features(noise=0.0, seed=2)
    return pb


def test_room_gaussians_and_lookups_match_reference(room):
    """The room of the registration test: its centroid lies on the lattice
    boundary to float32 rounding (x and y are 0 up to ~1e-7), where the two
    packages' sums may round to either side, so its keys may differ by a
    whole lattice cell; everything the registration reads does not."""
    want = jv.voxel_gaussians(room, voxel_size=1.0, max_voxels=4096)
    got = pv.voxel_gaussians(to_port(room), 1.0, 4096)
    for k in ("counts", "means", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["covs"].numpy(), np.asarray(want["covs"]), atol=1e-6, rtol=0)
    q = np.asarray(room.xyz)[np.asarray(room.mask)]
    ws, wf = jv.voxel_lookup7(want, jnp.asarray(q))
    gs, gf = pv.voxel_lookup7(got, torch.as_tensor(q))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


NDT_CASES = {
    "reference test": ([0.0, 0.0, 0.04], [0.25, -0.15, 0.0]),
    "tilted": ([0.01, -0.015, -0.05], [-0.2, 0.2, 0.04]),
}


def _pose_err(a, b):
    d = se3np.pose_between(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return (float(np.linalg.norm(se3np.pose_trans(d))),
            float(np.linalg.norm(se3np.so3_log(se3np.pose_quat(d)))))


@pytest.mark.parametrize("gaussians", ["reference's", "port's"])
@pytest.mark.parametrize("case", sorted(NDT_CASES))
def test_register_ndt_matches_float64_reference(room, case, gaussians):
    g = jv.voxel_gaussians(room, voxel_size=1.0, max_voxels=4096)
    true_pose = make_pose(*NDT_CASES[case])
    src = jv.voxel_downsample(room, 0.3, 4096).transform(jse3.pose_inverse(true_pose))
    want = reference_f64(jr.register_ndt, src, g, jse3.pose_identity())
    if gaussians == "port's":
        pg = pv.voxel_gaussians(to_port(room), 1.0, 4096)
    else:
        pg = {k: torch.as_tensor(np.array(v)) for k, v in g.items()}
    got = pr.register_ndt(to_port(src), pg, torch.as_tensor(np.array(jse3.pose_identity())))
    terr, rerr = _pose_err(want.pose, got.pose.numpy())
    assert terr < 1e-4 and rerr < 1e-4, (terr, rerr)
    for k in ("converged", "iterations", "n_constrained", "num_matches"):
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost), rtol=1e-4)
    terr, rerr = _pose_err(np.asarray(true_pose), got.pose.numpy())
    assert terr < 0.1 and rerr < 0.05, (terr, rerr)  # tests/test_registration.py's bounds


def test_ndt_params_match_reference():
    assert pr.NdtParams()._asdict() == jr.NdtParams()._asdict()


def test_ndt_projector_takes_the_absolute_floor():
    """``_ndt_projector`` keeps the eigenvectors of H + damping·I above
    ``degen_thresh`` whatever the match count (the reference's semantics)."""
    rng = np.random.default_rng(3)
    Q = np.linalg.qr(rng.normal(size=(6, 6)))[0]
    lam = np.array([1e3, 500.0, 80.0, 12.0, 9.0, 0.5])
    H = (Q * lam) @ Q.T
    P, n = pr._ndt_projector(torch.as_tensor(H, dtype=torch.float32), pr.NdtParams())
    Pj, nj = jr._ndt_projector(jnp.asarray(H, jnp.float32), jr.NdtParams())
    assert int(n) == int(nj) == 4
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), atol=1e-4)
