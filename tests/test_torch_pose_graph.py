"""The port's pose-graph solver (``lmsf_slam_tpu_torch.backend.pose_graph``)
against the reference (``lmsf_slam_tpu/backend/pose_graph.py``) on the same
numpy graphs, on the CPU.

Graphs of 24–48 vertices padded to 64: a drifted ring with two loop edges.
Both solvers run in float32 and sum the same terms in another order
(``index_add_`` against ``segment_sum``, torch's forward-mode Jacobians
against JAX's), so poses agree to 1e-3 m / 1e-3 rad (measured: ~4e-6) and
``chi2_final`` to 1e-3 relative. The GN iteration count is compared where it
is well defined: where the reference evaluated in float64 runs as many
iterations as it does in float32 (the exit compares a step norm with 1e-5,
which rounding can move across the line).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.backend import pose_graph as jpg
from lmsf_slam_tpu_torch.backend import pose_graph as ppg
from lmsf_slam_tpu_torch.common import se3np
from tests.test_torch_registration import reference_f64

VP = EP = 64


def ring_graph(V=32, seed=0, outlier=False):
    """A ring of V poses, odometry edges with noise, two loop edges, the
    initial guess drifted by a bias on every odometry step. Padded to
    (VP, EP); padded edges point at vertex 0 with the mask off."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, V, endpoint=False)
    yaw = th + np.pi / 2
    gt = np.zeros((V, 7))
    gt[:, 0], gt[:, 3] = np.cos(yaw / 2), np.sin(yaw / 2)
    gt[:, 4], gt[:, 5], gt[:, 6] = 10 * np.cos(th), 10 * np.sin(th), 0.3 * np.sin(2 * th)
    loops = [(0, V - 1), (1, V - 2)]
    if outlier:
        loops += [(2, V - 3), (0, V - 2), (1, V - 1), (3, V - 4)]
    eij = np.array([(i, i + 1) for i in range(V - 1)] + loops, np.int32)
    E = len(eij)
    z = se3np.pose_between(gt[eij[:, 0]], gt[eij[:, 1]])
    noise = rng.normal(size=(E, 6)) * np.array([0.002] * 3 + [0.02] * 3)
    z = se3np.pose_compose(z, se3np.se3_exp(noise))
    if outlier:
        z[-1, 4:] += [25.0, -30.0, 0.0]  # a gross wrong loop closure
    drift = se3np.se3_exp(np.array([0, 0, 0.004, 0.03, 0.01, 0.0]))
    init = [gt[0]]
    for i in range(V - 1):
        init.append(se3np.pose_compose(init[-1], se3np.pose_compose(z[i], drift)))
    P = np.zeros((VP, 7), np.float32)
    P[:, 0] = 1
    P[:V] = np.stack(init)
    vm = np.arange(VP) < V
    EI = np.zeros((EP, 2), np.int32)
    EI[:E] = eij
    Z = np.zeros((EP, 7), np.float32)
    Z[:, 0] = 1
    Z[:E] = z
    SW = np.zeros((EP, 6), np.float32)
    SW[:E] = 1 / np.sqrt(np.array([1e-4] * 3 + [0.0025] * 3))
    em = np.arange(EP) < E
    er = np.zeros(EP, bool)
    er[V - 1:E] = True
    return dict(poses=P, vmask=vm, edges_ij=EI, edges_z=Z, edges_sqrtw=SW, emask=em,
                edges_robust=er), gt.astype(np.float32)


def solve_both(g, jparams=None, check64=False, **kw):
    """(port poses, port stats, reference poses, reference stats, float64
    reference iterations or None). The float64 evaluation costs a second
    compilation of the reference, so only some cases ask for it."""
    kw = {**g, **kw}
    names = list(kw)
    pparams = ppg.PoseGraphParams(**(jparams or {}))
    jparams = jpg.PoseGraphParams(**(jparams or {}))
    jo, js = jpg.optimize_pose_graph(**{k: jnp.asarray(kw[k]) for k in names}, params=jparams)
    po, ps = ppg.optimize_pose_graph(**{k: torch.as_tensor(np.array(kw[k])) for k in names},
                                     params=pparams)

    def f64(*arrays):
        return jpg.optimize_pose_graph(**dict(zip(names, arrays)), params=jparams)

    it64 = None
    if check64:
        it64 = int(reference_f64(f64, *(kw[k] for k in names))[1].iterations)
    return po.numpy(), ps, np.asarray(jo), js, it64


def assert_same_solution(po, ps, jo, js, it64, n):
    d = se3np.pose_between(jo[:n].astype(np.float64), po[:n].astype(np.float64))
    assert np.linalg.norm(se3np.pose_trans(d), axis=-1).max() < 1e-3
    assert np.linalg.norm(se3np.so3_log(se3np.pose_quat(d)), axis=-1).max() < 1e-3
    np.testing.assert_array_equal(po[n:], jo[n:])  # padded vertices untouched
    np.testing.assert_allclose(float(ps.chi2_initial), float(js.chi2_initial), rtol=1e-4)
    np.testing.assert_allclose(float(ps.chi2_final), float(js.chi2_final), rtol=1e-3)
    if it64 is None or it64 == int(js.iterations):
        assert int(ps.iterations) == int(js.iterations)
    assert ps.iterations.dtype == torch.int32


KERNELS = [
    dict(kernel="none"), dict(kernel="huber"), dict(kernel="huber", kernel_delta=1.0),
    dict(kernel="cauchy"), dict(kernel="dcs"), dict(kernel="tls"),
    dict(kernel="tls", gnc_iters=4), dict(kernel="dcs", gnc_iters=3, gnc_mu0=50.0),
]


CHECK64 = [dict(kernel="huber"), dict(kernel="tls", gnc_iters=4)]


@pytest.mark.parametrize("params", KERNELS, ids=lambda p: "-".join(f"{v}" for v in p.values()))
def test_drifted_ring_matches_reference(params):
    g, gt = ring_graph()
    po, ps, jo, js, it64 = solve_both(g, params, check64=params in CHECK64)
    assert_same_solution(po, ps, jo, js, it64, 32)
    assert float(ps.chi2_final) < 0.01 * float(ps.chi2_initial)
    assert np.linalg.norm(po[:32, 4:] - gt[:, 4:], axis=1).max() < 0.3


@pytest.mark.parametrize("params", [dict(kernel="tls", gnc_iters=6), dict(kernel="huber")],
                         ids=["tls-gnc", "huber"])
def test_outlier_loop_edge_matches_reference(params):
    """A 40 m wrong loop closure: annealed TLS cuts it (the consensus-median
    floor sorts the robust edges' residuals with inf padding), huber only
    tempers it. Either way the port does what the reference does."""
    g, gt = ring_graph(V=24, seed=3, outlier=True)
    po, ps, jo, js, it64 = solve_both(g, params)
    assert_same_solution(po, ps, jo, js, it64, 24)
    if params["kernel"] == "tls":
        assert np.linalg.norm(po[:24, 4:] - gt[:, 4:], axis=1).max() < 0.5


def test_fixed_vertices_stay_and_small_budgets_match():
    g, _ = ring_graph(V=40, seed=1)
    fixed = np.zeros(VP, bool)
    fixed[[0, 1, 2, 20]] = True
    po, ps, jo, js, it64 = solve_both(g, dict(gn_iters=3, pcg_iters=5), fixed=fixed)
    assert_same_solution(po, ps, jo, js, it64, 40)
    np.testing.assert_array_equal(po[fixed], g["poses"][fixed])
    assert int(ps.iterations) == 3


def _priors(V, gt, kind, seed=5):
    rng = np.random.default_rng(seed)
    K = 8
    idx = np.zeros(K, np.int32)
    mask = np.arange(K) < 6
    idx[:6] = rng.choice(V, 6, replace=False)
    if kind == "gnss":
        xyz = np.zeros((K, 3), np.float32)
        xyz[:6] = gt[idx[:6], 4:]
        return dict(prior_xyz=xyz, prior_idx=idx, prior_sqrtw=np.full((K, 3), 20.0, np.float32),
                    prior_mask=mask)
    if kind == "quat":
        q = np.zeros((K, 4), np.float32)
        q[:, 0] = 1
        q[:6] = gt[idx[:6], :4]
        return dict(qprior_quat=q, qprior_idx=idx,
                    qprior_sqrtw=np.full((K, 3), 50.0, np.float32), qprior_mask=mask)
    return dict(plane_idx=idx, plane_z=np.zeros(K, np.float32),
                plane_sqrtw=np.broadcast_to(np.array([10.0, 20.0, 20.0], np.float32), (K, 3)).copy(),
                plane_mask=mask)


@pytest.mark.parametrize("kinds", [("gnss",), ("quat",), ("plane",), ("gnss", "quat", "plane")],
                         ids="+".join)
def test_unary_priors_match_reference(kinds):
    """GNSS position, quaternion and plane priors, alone and together, with
    every vertex free (the priors are the gauge) except where only
    orientation or the plane is constrained."""
    g, gt = ring_graph(V=32, seed=2)
    priors = {}
    for kind in kinds:
        priors.update(_priors(32, gt, kind))
    fixed = np.zeros(VP, bool)
    fixed[0] = "gnss" not in kinds
    po, ps, jo, js, it64 = solve_both(g, dict(kernel="none"), check64=len(kinds) == 3,
                                      fixed=fixed, **priors)
    assert_same_solution(po, ps, jo, js, it64, 32)
    if "gnss" in kinds:
        idx = priors["prior_idx"][:6]
        assert np.linalg.norm(po[idx, 4:] - gt[idx, 4:], axis=1).max() < 0.1


def test_edge_jacobians_match_reference_and_finite_differences():
    g, _ = ring_graph(V=24, seed=4)
    E = 25
    pi, pj = g["poses"][g["edges_ij"][:E, 0]], g["poses"][g["edges_ij"][:E, 1]]
    z = g["edges_z"][:E]
    rj, Jij, Jjj = jax.jit(jax.vmap(jpg._edge_res_jac))(jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(z))
    r, Ji, Jj = ppg._edge_res_jac(*(torch.as_tensor(a) for a in (pi, pj, z)))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(Jij), atol=2e-4)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(Jjj), atol=2e-4)
    # central differences of the port's own residual, in float64
    pi64, pj64, z64 = (torch.as_tensor(a, dtype=torch.float64) for a in (pi, pj, z))
    _, Ji64, Jj64 = ppg._edge_res_jac(pi64, pj64, z64)
    h = 1e-6
    for col in range(12):
        x = torch.zeros(E, 12, dtype=torch.float64)
        x[:, col] = h
        fd = (ppg._edge_boxplus(x, pi64, pj64, z64) - ppg._edge_boxplus(-x, pi64, pj64, z64)) / (2 * h)
        J = Ji64[..., col] if col < 6 else Jj64[..., col - 6]
        np.testing.assert_allclose(J.numpy(), fd.numpy(), atol=1e-6)
    np.testing.assert_allclose(Ji.numpy(), Ji64.numpy(), atol=2e-4)


@pytest.mark.parametrize("fn", ["_xyz_res", "_quat_res", "_plane_res"])
def test_unary_jacobians_match_finite_differences(fn):
    rng = np.random.default_rng(6)
    K = 10
    pose = se3np.se3_exp(rng.normal(size=(K, 6)) * np.array([0.4] * 3 + [5.0] * 3))
    z = {"_xyz_res": rng.normal(size=(K, 3)),
         "_quat_res": se3np.se3_exp(rng.normal(size=(K, 6)) * 0.4)[:, :4],
         "_plane_res": rng.normal(size=K)}[fn]
    sw = rng.uniform(1.0, 20.0, size=(K, 3))
    pose, z, sw = (torch.as_tensor(a, dtype=torch.float64) for a in (pose, z, sw))
    f = getattr(ppg, fn)
    r, J = ppg._unary_res_jac(f, pose, z, sw)
    assert r.shape == (K, 3) and J.shape == (K, 3, 6)
    h = 1e-6
    for col in range(6):
        x = torch.zeros(K, 6, dtype=torch.float64)
        x[:, col] = h
        fd = (f(x, pose, z, sw) - f(-x, pose, z, sw)) / (2 * h)
        np.testing.assert_allclose(J[..., col].numpy(), fd.numpy(), atol=1e-6)


def test_edge_residual_matches_reference():
    g, _ = ring_graph()
    pi, pj, z = g["poses"][:31], g["poses"][1:32], g["edges_z"][:31]
    want = jax.jit(jax.vmap(jpg.edge_residual))(*(jnp.asarray(a) for a in (pi, pj, z)))
    got = ppg.edge_residual(*(torch.as_tensor(a) for a in (pi, pj, z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("kernel", ["none", "huber", "cauchy", "dcs", "tls"])
def test_robust_weight_matches_reference(kernel):
    r2 = np.concatenate([[0.0, 1e-14], np.geomspace(1e-3, 1e5, 200)]).astype(np.float32)
    for delta in (10.0, 0.7):
        want = jpg._robust_weight(jnp.asarray(r2), kernel, jnp.float32(delta))
        got = ppg._robust_weight(torch.as_tensor(r2), kernel, delta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown robust kernel"):
        ppg._robust_weight(torch.as_tensor(r2), "l1", 1.0)


def test_gnc_delta_and_clamp_step_match_reference():
    for kw in (dict(), dict(gnc_iters=5), dict(gnc_iters=3, gnc_mu0=40.0, kernel_delta=2.5)):
        for t in range(8):
            want = float(jpg._gnc_delta(jpg.PoseGraphParams(**kw), jnp.int32(t)))
            assert ppg._gnc_delta(ppg.PoseGraphParams(**kw), t) == pytest.approx(want, rel=1e-6)
    rng = np.random.default_rng(8)
    dx = (rng.normal(size=(50, 6)) * np.array([0.4] * 3 + [4.0] * 3)).astype(np.float32)
    dx[0] = 0
    want = jpg._clamp_step(jnp.asarray(dx), jpg.PoseGraphParams())
    got = ppg._clamp_step(torch.as_tensor(dx), ppg.PoseGraphParams())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("n_robust", [0, 1, 4, 7])
def test_edge_weights_median_floor_matches_reference(n_robust):
    """The consensus-median floor: 3 × the lower median residual norm of the
    valid robust edges (sorted with inf padding), 0 robust edges included."""
    rng = np.random.default_rng(9)
    E = 16
    r2 = (rng.uniform(0.1, 30.0, E) ** 2).astype(np.float32)
    er = np.zeros(E, bool)
    er[rng.choice(E, n_robust, replace=False)] = True
    em = np.arange(E) < 13
    for kernel in ("tls", "dcs", "cauchy", "huber"):
        jp, pp = jpg.PoseGraphParams(kernel=kernel, kernel_delta=2.0), \
            ppg.PoseGraphParams(kernel=kernel, kernel_delta=2.0)
        want = jpg._edge_weights(*(jnp.asarray(a) for a in (r2, er, em)), jp, jnp.int32(0))
        got = ppg._edge_weights(*(torch.as_tensor(a) for a in (r2, er, em)), pp, 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_params_match_reference():
    assert ppg.PoseGraphParams()._asdict() == jpg.PoseGraphParams()._asdict()
    assert ppg.PoseGraphStats._fields == jpg.PoseGraphStats._fields


def test_late_flag_reads_do_not_change_the_solve(monkeypatch):
    """The PCG exit flag is read every PCG_CHECK_EVERY iterations and the
    iterations in between are frozen: reading it every iteration gives the
    same poses bit for bit."""
    g, _ = ring_graph()
    args = {k: torch.as_tensor(v) for k, v in g.items()}
    a, sa = ppg.optimize_pose_graph(**args)
    monkeypatch.setattr(ppg, "PCG_CHECK_EVERY", 1)
    b, sb = ppg.optimize_pose_graph(**args)
    assert torch.equal(a, b) and int(sa.iterations) == int(sb.iterations)
