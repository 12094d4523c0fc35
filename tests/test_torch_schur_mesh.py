"""The port's Schur solve over a mesh (``optimize_pose_graph_schur(mesh=)``)
against the port without one and against the reference's on ``make_mesh(4)``,
on the CPU: the mesh cases of ``tests/test_schur.py``.

Four ranks are four processes in a gloo group on the CPU (through a
``file://`` store under ``tmp_path``), each eliminating two of eight submaps.
The all-reduce sums the ranks' separator systems in another order than one
process sums the submaps, so over 8 GN iterations the solutions part by
float32 rounding. On the 96-vertex graph they part along its flat modes by
~1e-3 whatever changes the rounding: the reference on its mesh lies 4.8e-4
from itself on one device, the port on one process 7.8e-4 from the reference
on one device (measured on the CPU). So poses are held to the reference
test's own 2e-3, against the port without a mesh and against the reference
on its mesh alike; chi2 within 1e-2 of the port without a mesh and within
1e-4 relative of the reference, and the same GN iteration count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.backend import pose_graph as jpg
from lmsf_slam_tpu.parallel import distributed as jdist
from lmsf_slam_tpu.parallel import schur as jsc
from lmsf_slam_tpu_torch.backend import pose_graph as ppg
from lmsf_slam_tpu_torch.parallel import multihost
from lmsf_slam_tpu_torch.parallel import schur as psc
from tests import torch_ranks
from tests.test_torch_schur import chain_graph, geo_err
from tests import torch_threads  # noqa: F401

MESH_AGREE = 2e-3  # tests/test_schur.py::test_schur_mesh_matches_single
CHI2_AGREE = 1e-2
CHI2_REFERENCE = 1e-4  # relative
PARAMS = dict(gn_iters=8, kernel="none")


def mesh_graph():
    """``test_schur_mesh_matches_single``'s graph: 96 vertices, 8 loops."""
    poses, eij, ez, _ = chain_graph(n=96, n_loops=8, seed=3)
    E = eij.shape[0]
    return dict(poses=poses, edges_ij=eij, edges_z=ez,
                edges_sqrtw=np.full((E, 6), 10.0, np.float32), emask=np.ones(E, bool))


def prior_graph():
    """``test_schur_unary_priors_on_mesh``'s graph: 64 vertices, 6 loops, a
    GNSS position prior on every sixth vertex, nothing fixed."""
    poses, eij, ez, gt = chain_graph(n=64, n_loops=6, noise=0.02, seed=11)
    V, E = poses.shape[0], eij.shape[0]
    ids = np.arange(0, V, 6, dtype=np.int32)
    K = 16
    pidx, pmask = np.zeros(K, np.int32), np.zeros(K, bool)
    pxyz = np.zeros((K, 3), np.float32)
    pidx[: ids.size], pmask[: ids.size] = ids, True
    pxyz[: ids.size] = gt[ids, 4:]
    return dict(poses=poses, edges_ij=eij, edges_z=ez,
                edges_sqrtw=np.full((E, 6), 10.0, np.float32), emask=np.ones(E, bool),
                fixed=np.zeros(V, bool), prior_xyz=pxyz, prior_idx=pidx,
                prior_sqrtw=np.full((K, 3), 10.0, np.float32), prior_mask=pmask)


CASES = {
    "mesh": (mesh_graph, 8),
    "priors": (prior_graph, 8),
    "rounded": (mesh_graph, 6),  # 6 submaps over 4 ranks: rounded up to 8
}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("store") / "schur"
    cases = [(name, dict(make(), n_submaps=S), PARAMS) for name, (make, S) in CASES.items()]
    return multihost.launch_local(torch_ranks.schur_solves, 4, args=(cases,), backend="gloo",
                                  init_method=f"file://{store}", timeout=120.0, threads=1)


def port_single(graph, S):
    kw = dict(graph)
    poses = torch.as_tensor(kw.pop("poses"))
    out, stats = psc.optimize_pose_graph_schur(poses, **kw, n_submaps=S,
                                               params=ppg.PoseGraphParams(**PARAMS))
    return out.numpy(), stats


def reference_mesh(graph, S):
    kw = {k: (v if k == "fixed" else jnp.asarray(v)) for k, v in graph.items()}
    poses = kw.pop("poses")
    out, stats = jsc.optimize_pose_graph_schur(
        poses, **kw, n_submaps=S, mesh=jdist.make_mesh(4, backend="cpu"),
        params=jpg.PoseGraphParams(**PARAMS))
    return np.asarray(out), stats


@pytest.mark.parametrize("case", ["mesh", "priors"])
def test_schur_on_four_ranks_matches_single_and_reference(case, four_ranks):
    make, S = CASES[case]
    g = make()
    out, stats = four_ranks[0][case]
    for r in four_ranks[1:]:  # the result is replicated
        np.testing.assert_array_equal(r[case][0], out)
    base, base_stats = port_single(g, S)
    np.testing.assert_allclose(out, base, atol=MESH_AGREE)
    assert abs(stats["chi2_final"] - float(base_stats.chi2_final)) < CHI2_AGREE
    jo, js = reference_mesh(g, S)
    assert geo_err(out, jo) < MESH_AGREE
    np.testing.assert_allclose(stats["chi2_final"], float(js.chi2_final), rtol=CHI2_REFERENCE)
    assert stats["iterations"] == int(js.iterations)


def test_submaps_round_up_to_the_mesh(four_ranks):
    """Six submaps over four ranks run as eight, as the reference rounds."""
    rounded, stats = four_ranks[0]["rounded"]
    np.testing.assert_array_equal(rounded, four_ranks[0]["mesh"][0])
    jo, _ = reference_mesh(mesh_graph(), 6)
    assert geo_err(rounded, jo) < MESH_AGREE
