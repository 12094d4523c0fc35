"""The port's edge-sharded pose-graph solve
(``lmsf_slam_tpu_torch.parallel.distributed``) against the reference's
(``lmsf_slam_tpu/parallel/distributed.py``) on the same numpy graphs, on the
CPU: the cases of ``tests/test_parallel.py``.

One rank is a world of one in this process; four ranks are four processes in
a gloo group on the CPU (``multihost.launch_local`` through a ``file://``
store under ``tmp_path``), each running ``tests/torch_ranks.py``. The
reference runs on ``make_mesh(1|4, backend="cpu")``, a mesh of the virtual
CPU devices. Both solve in float32 with the same fixed-length PCG and sum the
same terms in another order (``index_add_`` and gloo's all-reduce against
``segment_sum`` and ``psum``): poses agree to 1e-4, and to the port's
replicated solver to 5e-4 (the reference test's own bound).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.backend import pose_graph as jpg
from lmsf_slam_tpu.parallel import distributed as jdist
from lmsf_slam_tpu_torch.backend import pose_graph as ppg
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.parallel import make_mesh, multihost, optimize_pose_graph_sharded
from tests import torch_ranks
from tests import torch_threads  # noqa: F401

AGREE = 1e-4  # port vs reference, same algorithm
REPLICATED = 5e-4  # tests/test_parallel.py: sharded vs replicated
PARAMS = dict(gn_iters=8, pcg_iters=48)
SMALL = dict(gn_iters=4, pcg_iters=32)


def ring_graph(n=24, noise=0.05, seed=0, sqrtw=10.0):
    """Noisy ring with its closing edge, the odometry chained from the noisy
    edges (``tests/test_parallel.py::_ring_graph``), as float32 numpy."""
    rng = np.random.default_rng(seed)
    step = se3np.se3_exp(np.array([0.0, 0.0, 2 * np.pi / n, 2.0, 0.0, 0.0]))
    gt = [se3np.pose_identity()]
    for _ in range(n - 1):
        gt.append(se3np.pose_compose(gt[-1], step))
    eij, ez = [], []
    for i in range(n):
        j = (i + 1) % n
        z = se3np.pose_between(gt[i], gt[j])
        eij.append((i, j))
        ez.append(np.float32(se3np.pose_compose(z, se3np.se3_exp(rng.normal(0, noise, 6)))))
    init = [gt[0]]
    for e in range(n - 1):
        init.append(se3np.pose_compose(init[-1], ez[e]))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(poses=f32(np.stack(init)), vmask=np.ones(n, bool),
                edges_ij=np.asarray(eij, np.int32), edges_z=f32(np.stack(ez)),
                edges_sqrtw=np.full((n, 6), sqrtw, np.float32), emask=np.ones(n, bool))


def geo_err(a, b):
    d = se3np.pose_between(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return float(np.abs(se3np.pose_log(d)).max())


def reference_sharded(graph, params, n_dev):
    mesh = jdist.make_mesh(n_dev, backend="cpu")
    out, stats = jdist.optimize_pose_graph_sharded(
        *(jnp.asarray(graph[k]) for k in ("poses", "vmask", "edges_ij", "edges_z",
                                          "edges_sqrtw", "emask")),
        mesh, params=jpg.PoseGraphParams(**params))
    return np.asarray(out), stats


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Both rings solved once by four CPU ranks."""
    store = tmp_path_factory.mktemp("store") / "parallel"
    cases = [("ring24", ring_graph(), PARAMS), ("ring11", ring_graph(n=11, sqrtw=1.0), SMALL)]
    results = multihost.launch_local(torch_ranks.sharded_solves, 4, args=(cases,),
                                     backend="gloo", init_method=f"file://{store}",
                                     timeout=120.0, threads=1)
    return results


def one_rank(graph, params):
    mesh = make_mesh(backend="cpu")
    out, stats = optimize_pose_graph_sharded(
        torch.as_tensor(graph["poses"]), graph["vmask"], graph["edges_ij"], graph["edges_z"],
        graph["edges_sqrtw"], graph["emask"], mesh, params=ppg.PoseGraphParams(**params))
    return out.numpy(), {k: float(v) for k, v in stats._asdict().items()}


@pytest.mark.parametrize("n_dev", [1, 4])
def test_sharded_matches_reference_and_single(n_dev, four_ranks):
    g = ring_graph()
    if n_dev == 1:
        out, stats = one_rank(g, PARAMS)
    else:
        out, stats = four_ranks[0]["ring24"]
        for r in four_ranks[1:]:  # every rank returns the same poses
            np.testing.assert_array_equal(r["ring24"][0], out)
    jo, js = reference_sharded(g, PARAMS, n_dev)
    assert geo_err(out, jo) < AGREE
    np.testing.assert_allclose(stats["chi2_final"], float(js.chi2_final), rtol=AGREE)
    np.testing.assert_allclose(stats["chi2_initial"], float(js.chi2_initial), rtol=AGREE)
    assert int(stats["iterations"]) == int(js.iterations)
    t = {k: torch.as_tensor(v) for k, v in g.items()}
    ref, ref_stats = ppg.optimize_pose_graph(**t, params=ppg.PoseGraphParams(**PARAMS))
    np.testing.assert_allclose(out, ref.numpy(), atol=REPLICATED)
    assert stats["chi2_final"] <= float(ref_stats.chi2_initial)


def test_sharded_pads_uneven_edges(four_ranks):
    """11 edges over 4 ranks: one padding edge; finite, chi2 not above its start."""
    out, stats = four_ranks[0]["ring11"]
    assert np.isfinite(out).all()
    assert stats["chi2_final"] <= stats["chi2_initial"] + 1e-6
    jo, _ = reference_sharded(ring_graph(n=11, sqrtw=1.0), SMALL, 4)
    assert geo_err(out, jo) < AGREE


def test_make_mesh_beyond_the_world_raises(four_ranks):
    assert all(r["beyond_world_raised"] for r in four_ranks)
    with pytest.raises(ValueError):
        make_mesh(2, backend="cpu")  # a world of one here
    with pytest.raises(ValueError):
        make_mesh(backend="tpu")


def test_make_mesh_over_fewer_ranks_than_the_world(four_ranks):
    """``make_mesh(2)`` in a world of four: ranks 0 and 1 form the mesh, the
    others get None."""
    assert [r["sub_mesh"] for r in four_ranks] == [(2, 0), (2, 1), None, None]
    assert [r.get("sub_sum") for r in four_ranks] == [2.0, 2.0, None, None]


def test_make_mesh_on_the_card_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        assert make_mesh().device.type == "cuda"
    else:
        with pytest.raises(ValueError, match="CUDA"):
            make_mesh()


def test_backend_choice():
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert multihost.choose_backend(cards + 1) == "gloo"  # ranks would share a card
    if cards:
        assert multihost.choose_backend(cards) == "nccl"
