"""The port's submap Schur solve (``lmsf_slam_tpu_torch.parallel.schur``)
against the reference (``lmsf_slam_tpu/parallel/schur.py``) on the same numpy
graphs, on the CPU: the single-device cases of ``tests/test_schur.py``.

Each case runs both packages' Schur solves and holds the port to the
reference's solution, then holds the port to the reference test's own bounds
against the port's replicated solver. Both solve in float32 with the same
elimination; the Jacobians (torch's forward mode against JAX's) and the
factorizations (LAPACK in both, called differently) round differently, so
poses agree to 1e-4 (m and rad) and chi2 to rtol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.backend import pose_graph as jpg
from lmsf_slam_tpu.parallel import schur as jsc
from lmsf_slam_tpu_torch.backend import pose_graph as ppg
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.interop import submap_partition_from_numpy
from lmsf_slam_tpu_torch.parallel import schur as psc
from tests import torch_threads  # noqa: F401

AGREE = 1e-4


def chain_graph(n=64, n_loops=6, noise=0.03, seed=0):
    """Noisy odometry chain + long-range exact loop edges (the topology of
    ``tests/test_schur.py::_chain_graph``), as float32 numpy."""
    rng = np.random.default_rng(seed)
    step = se3np.se3_exp(np.array([0.0, 0.0, 0.08, 1.5, 0.0, 0.0]))
    gt = [se3np.pose_identity()]
    for _ in range(n - 1):
        gt.append(se3np.pose_compose(gt[-1], step))
    gt = np.stack(gt)
    eij, ez = [], []
    for i in range(n - 1):
        z = se3np.pose_between(gt[i], gt[i + 1])
        eij.append((i, i + 1))
        ez.append(se3np.pose_compose(z, se3np.se3_exp(rng.normal(0, noise, 6))))
    for _ in range(n_loops):
        i = int(rng.integers(0, n // 3))
        j = int(rng.integers(2 * n // 3, n))
        eij.append((i, j))
        ez.append(se3np.pose_between(gt[i], gt[j]))
    init = [gt[0]]
    for e in range(n - 1):
        init.append(se3np.pose_compose(init[-1], ez[e]))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(np.stack(init)), np.asarray(eij, np.int32), f32(np.stack(ez)), f32(gt)


def geo_err(a, b):
    d = se3np.pose_between(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return float(np.abs(se3np.pose_log(d)).max())


def schur_both(poses, eij, ez, sqrtw, emask, params, **kw):
    """(port poses, port stats, reference poses, reference stats)."""
    jo, js = jsc.optimize_pose_graph_schur(
        jnp.asarray(poses), jnp.asarray(eij), jnp.asarray(ez), jnp.asarray(sqrtw),
        jnp.asarray(emask), params=jpg.PoseGraphParams(**params),
        **{k: (v if k == "fixed" else jnp.asarray(v)) for k, v in kw.items()})
    po, ps = psc.optimize_pose_graph_schur(
        torch.as_tensor(poses), eij, ez, sqrtw, emask, params=ppg.PoseGraphParams(**params),
        **{k: (v if k in ("fixed", "n_submaps") else torch.as_tensor(v))
           for k, v in kw.items()})
    return po.numpy(), ps, np.asarray(jo), js


def assert_same(po, ps, jo, js):
    assert geo_err(po, jo) < AGREE
    assert int(ps.iterations) == int(js.iterations) and ps.iterations.dtype == torch.int32
    np.testing.assert_allclose(float(ps.chi2_initial), float(js.chi2_initial), rtol=AGREE)
    np.testing.assert_allclose(float(ps.chi2_final), float(js.chi2_final), rtol=AGREE,
                               atol=1e-5)


def replicated(poses, eij, ez, sqrtw, emask, params, **kw):
    V = poses.shape[0]
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    return ppg.optimize_pose_graph(
        t(poses), torch.ones(V, dtype=torch.bool), t(eij), t(ez), t(sqrtw), t(emask),
        params=ppg.PoseGraphParams(**params), **{k: t(v) for k, v in kw.items()})


def test_schur_matches_replicated_single_device():
    """The elimination is algebraically exact, so at tight convergence it
    reaches the replicated PCG solve's optimum; and it is the reference's
    Schur solve."""
    poses, eij, ez, _ = chain_graph(n=48, n_loops=4)
    E = eij.shape[0]
    sqrtw = np.full((E, 6), 10.0, np.float32)
    emask = np.ones(E, bool)
    params = dict(gn_iters=40, kernel="none", converged_dx=1e-7)
    po, ps, jo, js = schur_both(poses, eij, ez, sqrtw, emask, params, n_submaps=4)
    assert_same(po, ps, jo, js)
    ref, ref_stats = replicated(poses, eij, ez, sqrtw, emask,
                                dict(params, pcg_iters=256))
    assert float(ps.chi2_final) <= float(ref_stats.chi2_final) * 1.05 + 1e-4
    assert geo_err(ref.numpy(), po) < 5e-3


def test_schur_respects_fixed_gauge():
    poses, eij, ez, _ = chain_graph(n=48, n_loops=4, seed=5)
    E = eij.shape[0]
    sqrtw = np.full((E, 6), 10.0, np.float32)
    po, ps, jo, js = schur_both(poses, eij, ez, sqrtw, np.ones(E, bool),
                                dict(gn_iters=8, kernel="none"), n_submaps=4)
    assert_same(po, ps, jo, js)
    # default gauge: vertex 0 fixed exactly
    np.testing.assert_allclose(po[0], poses[0], atol=1e-6)


@pytest.mark.parametrize("case", ["square", "square-fixed", "chain-priors"])
def test_partition_classifies_separators(case):
    """Cross-submap edge endpoints (and only those) become separators; the
    port's partition equals the reference's field by field."""
    if case.startswith("square"):
        eij = np.array([[0, 1], [1, 2], [2, 3], [0, 3]], np.int32)
        emask, V, S, uv = np.ones(4, bool), 4, 2, None
        fixed = None
        if case == "square-fixed":
            fixed = np.zeros(4, bool)
            fixed[0] = True
    else:
        _, eij, _, _ = chain_graph(n=40, n_loops=5, seed=2)
        emask = np.arange(eij.shape[0]) != 7  # one masked edge
        V, S, fixed, uv = 40, 4, np.arange(40) >= 37, np.array([0, 5, 9, 10, 21, 38])
    got = psc.partition_graph(eij, emask, V=V, n_submaps=S, fixed=fixed, unary_vid=uv)
    want = jsc.partition_graph(eij, emask, V=V, n_submaps=S, fixed=fixed, unary_vid=uv)
    assert got._fields == want._fields
    # the reference's partition carried over is the port's, field by field
    carried = submap_partition_from_numpy(want)
    for name, g, w in zip(got._fields, got, carried):
        if isinstance(w, int):
            assert g == w, name
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    sep = set(int(v) for v in got.sep_ids if v >= 0)
    if case == "square":
        # submaps {0,1} and {2,3}; edges (1,2) and (0,3) cross
        assert sep == {0, 1, 2, 3}
    elif case == "square-fixed":
        assert sep == {1, 2, 3}
        # the fixed vertex is neither interior nor separator
        assert 0 not in set(int(v) for v in got.int_ids.ravel() if v >= 0)


def test_backend_schur_path_matches_replicated():
    """``LifelongBackend.optimize(full=True)`` through the Schur path
    (``schur_min_vertices`` lowered to trigger on a small database) reaches
    the replicated solve's optimum, and the reference backend's Schur
    solution."""
    from lmsf_slam_tpu.backend import LifelongBackend as JBackend
    from lmsf_slam_tpu.backend import LifelongConfig as JConfig
    from lmsf_slam_tpu.backend import LoopConfig as JLoop
    from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
    from lmsf_slam_tpu_torch.backend import KeyframeDatabase, LifelongBackend, LifelongConfig
    from lmsf_slam_tpu_torch.backend import LoopConfig
    from lmsf_slam_tpu_torch.common.pointcloud import PointBatch

    clouds = [np.random.default_rng(seed).normal(size=(32, 3)).astype(np.float32) * 5
              for seed in list(range(24)) + list(range(100, 124))]
    rng = np.random.default_rng(0)
    step = se3np.se3_exp(np.array([0, 0, 0.07, 1.0, 0, 0]))
    odom, pose = [], se3np.pose_identity()
    for i in range(24):
        odom.append(se3np.pose_compose(pose, se3np.se3_exp(rng.normal(0, 0.02, 6))).astype(
            np.float32))
        pose = se3np.pose_compose(pose, step)
    params = dict(gn_iters=20, pcg_iters=128, kernel="none", converged_dx=1e-7)

    def port(**kw):
        b = LifelongBackend(db=KeyframeDatabase(edge_capacity=32, surf_capacity=32, device="cpu"),
                            config=LifelongConfig(optimize_batch=10**9,
                                                  pose_graph=ppg.PoseGraphParams(**params), **kw),
                            loop_config=LoopConfig(min_frame_interval=10**9))
        for i in range(24):
            b.add_keyframe(0.1 * i, PointBatch(torch.as_tensor(clouds[i]),
                                               torch.ones(32, dtype=torch.bool),
                                               torch.zeros((32, 0))),
                           PointBatch(torch.as_tensor(clouds[24 + i]),
                                      torch.ones(32, dtype=torch.bool), torch.zeros((32, 0))),
                           odom[i])
        return b, b.optimize(full=True)

    rep, _ = port()
    sch, ps = port(schur_submaps=4, schur_min_vertices=8)
    assert sch.solver_runs["full_schur"] == 1 and rep.solver_runs["full_schur"] == 0
    assert [s["kind"] for s in sch.solve_log] == ["full_schur"]
    assert geo_err(rep.db.map_poses[:24], sch.db.map_poses[:24]) < 5e-3

    ref = JBackend(config=JConfig(optimize_batch=10**9, pose_graph=jpg.PoseGraphParams(**params),
                                  schur_submaps=4, schur_min_vertices=8),
                   loop_config=JLoop(min_frame_interval=10**9))
    for i in range(24):
        ref.add_keyframe(0.1 * i, JPB.from_points(clouds[i], capacity=32),
                         JPB.from_points(clouds[24 + i], capacity=32), odom[i])
    js = ref.optimize(full=True)
    assert ref.solver_runs == sch.solver_runs
    assert geo_err(ref.db.map_poses[:24], sch.db.map_poses[:24]) < AGREE
    assert sch.solve_log[0]["iterations"] == int(ps.iterations) == int(js.iterations)
