"""The port's scan-to-map registration (``lmsf_slam_tpu_torch.ops.registration``)
against the reference (``lmsf_slam_tpu/ops/registration.py``), on the same
numpy inputs, on the CPU.

Which reference. The reference runs in float32, where two of its steps are
ill-conditioned: the analytic 3×3 eigenvectors of near-collinear neighbour
sets (five points along one scan ring: the plane normal lies in a 2-D
subspace whose two eigenvalues differ by ~1e-4 of the largest), and the
float32 degeneracy projector P, whose ~5e-7 rounding the κ = 1e7 penalty
turns into O(1) noise on JᵀJ. There the float32 result is set by rounding
order: on the room scans below the float32 reference lies 2.4e-5 to
1.2e-4 m from its own float64 evaluation, the port within 2.2e-7 m
(``scripts/port_parity.py --registration``). The port computes both steps in
float64. So the end-to-end comparisons hold the
port against the SAME reference functions evaluated in float64
(``jax.enable_x64``, inputs widened exactly), at the tolerances of the
port's float32 arithmetic: pose 1e-5, ``converged`` / ``iterations`` /
``num_matches`` / ``n_constrained`` exact, ``final_cost`` rtol 1e-4. The
elementwise helpers are held against the float32 reference directly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.common import se3 as jse3
from lmsf_slam_tpu.ops import features as jf
from lmsf_slam_tpu.ops import registration as jr
from lmsf_slam_tpu.ops import voxel as jv
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch as PPB
from lmsf_slam_tpu_torch.ops import registration as pr
from tests.test_features import synthetic_room_scan
from tests import torch_threads  # noqa: F401

FLAGS = ("converged", "iterations", "num_matches", "n_constrained")


def widen(tree):
    """float32 → float64 and int32 → int64 (both exact), as jax arrays."""

    def one(a):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return jnp.asarray(a, jnp.float64)
        if a.dtype == np.int32:
            return jnp.asarray(a, jnp.int64)
        return jnp.asarray(a)

    return jax.tree.map(one, tree)


def reference_f64(fn, *arrays, **static):
    """``fn`` of the reference evaluated in float64 on the widened arrays;
    the result as numpy."""
    with jax.enable_x64(True):
        return jax.tree.map(np.asarray, fn(*widen(arrays), **static))


def to_port(pb) -> PPB:
    return PPB(*(torch.as_tensor(np.array(getattr(pb, f))) for f in ("xyz", "mask", "attr")))


def assert_result(got, want, pose_atol=1e-5):
    np.testing.assert_allclose(got.pose.numpy(), want.pose, atol=pose_atol, rtol=0)
    for k in FLAGS:
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost), rtol=1e-4)


def _pose(w, t):
    return jse3.make_pose(jse3.so3_exp_quat(jnp.asarray(w, jnp.float32)), jnp.asarray(t, jnp.float32))


CASES = [
    ([0.0, 0.0, 0.05], [0.3, -0.2, 0.05]),
    ([0.01, -0.02, -0.04], [-0.2, 0.25, 0.03]),
    ([0.0, 0.0, 0.1], [0.5, 0.1, 0.0]),
]


def _room(seed, surfs_per_sector=20):
    """Room features (map) and the same features seen from a known pose."""
    pb = synthetic_room_scan(noise=0.005, seed=seed)
    grid = jf.organize_scan(pb, rings=16, width=360)
    feats = jf.extract_loam_features(grid, edges_per_sector=8, surfs_per_sector=surfs_per_sector)
    inv = jse3.pose_inverse(_pose(*CASES[seed]))
    return pb, feats, feats.edge.transform(inv), feats.surf.transform(inv), inv


def test_huber_w_matches_reference():
    r = np.linspace(-2.0, 2.0, 401, dtype=np.float32)
    np.testing.assert_allclose(
        pr._huber_w(torch.as_tensor(r), 0.5).numpy(), np.asarray(jr._huber_w(jnp.asarray(r), 0.5)),
        rtol=1e-6,
    )


def test_gn_normal_equations_matches_reference():
    rng = np.random.default_rng(3)
    p = (rng.normal(size=(300, 3)) * 10).astype(np.float32)
    n = rng.normal(size=(300, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    r = (rng.normal(size=300) * 0.1).astype(np.float32)
    w = rng.random(300).astype(np.float32)
    R = np.asarray(jse3.quat_to_matrix(jse3.so3_exp_quat(jnp.asarray([0.1, -0.2, 0.3]))))
    Hj, gj = jr._gn_normal_equations(*(jnp.asarray(a) for a in (p, n, r, w, R)))
    Hp, gp = pr._gn_normal_equations(*(torch.as_tensor(a) for a in (p, n, r, w, R)))
    Hj, gj = np.asarray(Hj), np.asarray(gj)
    np.testing.assert_allclose(Hp.numpy(), Hj, rtol=1e-5, atol=1e-5 * np.abs(Hj).max())
    np.testing.assert_allclose(gp.numpy(), gj, rtol=1e-5, atol=1e-5 * np.abs(gj).max())


@pytest.mark.parametrize("degen_rel", [0.01, 0.0])
def test_degeneracy_projector_matches_reference(degen_rel):
    """A spectrum with two directions under the floor (0.01·1000 matches =
    10, or the absolute 100): same count, same projector."""
    rng = np.random.default_rng(7)
    V, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    lam = np.array([2.0, 5.0, 400.0, 900.0, 3000.0, 8000.0])
    H = ((V * lam) @ V.T).astype(np.float32)
    jp = jr.RegistrationParams(degen_rel=degen_rel)
    pp = pr.RegistrationParams(degen_rel=degen_rel)
    nm = 1000
    Pj, nj = jr._degeneracy_projector(jnp.asarray(H), jp, jnp.int32(nm))
    Pp, np_ = pr._degeneracy_projector(torch.as_tensor(H), pp, torch.tensor(nm, dtype=torch.int32))
    assert int(np_) == int(nj) == 4
    np.testing.assert_allclose(Pp.numpy(), np.asarray(Pj), atol=1e-5)
    # a broken-down solve (non-finite H): NaN projector, nothing constrained
    Hn = H.copy()
    Hn[0, 0] = np.nan
    Pj, nj = jr._degeneracy_projector(jnp.asarray(Hn), jp, jnp.int32(nm))
    Pp, np_ = pr._degeneracy_projector(torch.as_tensor(Hn), pp, torch.tensor(nm, dtype=torch.int32))
    assert int(np_) == int(nj) == 0
    assert np.isnan(Pp.numpy()).all() and np.isnan(np.asarray(Pj)).all()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["edge", "surf"])
def test_correspondences_match_reference(kind, seed):
    """Validity exact; normals (up to sign) and offsets to 1e-5 against the
    float64 evaluation of the reference's fits, on every row whose k-th and
    (k+1)-th nearest map points are not a near-tie: the port ranks
    candidates in float32, the float64 reference in float64, and a gap of
    under 1e-4 relative can pick a different fifth neighbour (measured: one
    row of 3840, gap 5e-5)."""
    _, feats, src_e, src_s, inv = _room(seed, surfs_per_sector=40)
    src, map_pb = (src_e, feats.edge) if kind == "edge" else (src_s, feats.surf)
    jfn = jr._edge_correspondences if kind == "edge" else jr._surf_correspondences
    pfn = pr._edge_correspondences if kind == "edge" else pr._surf_correspondences
    p_world = np.asarray(src.xyz)  # identity pose: the registration's first association
    nj, dj, vj = reference_f64(jfn, p_world, src.mask, map_pb, params=jr.RegistrationParams())
    n_p, d_p, v_p = pfn(torch.as_tensor(p_world), torch.as_tensor(np.asarray(src.mask)),
                        to_port(map_pb), pr.RegistrationParams())
    k = jr.RegistrationParams().k_neighbors
    d = np.sum((p_world[:, None, :].astype(np.float64)
                - np.asarray(map_pb.xyz, np.float64)[None]) ** 2, axis=-1)
    d = np.sort(np.where(np.asarray(map_pb.mask)[None], d, np.inf), axis=1)
    clear = d[:, k] - d[:, k - 1] > 1e-4 * d[:, k - 1]
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(v_p.numpy()[clear], vj[clear])
    assert vj.sum() > 20
    n_p, d_p = n_p.numpy()[clear], d_p.numpy()[clear]
    nj, dj = nj[clear], dj[clear]
    sign = np.where(np.sum(n_p * nj, axis=1) < 0, -1.0, 1.0)
    np.testing.assert_allclose(n_p * sign[:, None], nj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(d_p * sign, dj, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", range(len(CASES)))
def test_register_edge_surf_matches_reference(seed):
    _, feats, src_e, src_s, _ = _room(seed)
    ident = np.asarray(jse3.pose_identity())
    want = reference_f64(jr.register_edge_surf, src_e, src_s, feats.edge, feats.surf, ident)
    got = pr.register_edge_surf(to_port(src_e), to_port(src_s), to_port(feats.edge),
                                to_port(feats.surf), torch.as_tensor(ident))
    assert_result(got, want)
    assert bool(got.converged) and int(got.n_constrained) == 6
    # and it found the transform the source was made with
    np.testing.assert_allclose(got.pose.numpy()[4:], np.asarray(_pose(*CASES[seed]))[4:], atol=0.02)


@pytest.mark.parametrize("seed", range(len(CASES)))
def test_register_point_to_plane_matches_reference(seed):
    """Surf features against a second raw scan of the room (the sparse
    point-plane ICP of the reference's factory)."""
    _, _, _, src, _ = _room(seed)
    pb = synthetic_room_scan(noise=0.005, seed=10 + seed)
    ident = np.asarray(jse3.pose_identity())
    # the reference's register_point_to_plane is register_edge_surf with an
    # empty float32 edge set, which float64 cannot carry through its
    # lax.cond: call register_edge_surf as it does, with the empty set widened
    empty = jv.PointBatch.empty(8)
    want = reference_f64(jr.register_edge_surf, empty, src, empty, pb, ident)
    got = pr.register_point_to_plane(to_port(src), to_port(pb), torch.as_tensor(ident))
    assert_result(got, want)


def test_registration_params_match_reference():
    assert pr.RegistrationParams()._asdict() == jr.RegistrationParams()._asdict()
