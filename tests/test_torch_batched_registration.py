"""The port's batched frame registration and sharded SLAM step
(``lmsf_slam_tpu_torch.parallel.distributed``) against the reference's
(``lmsf_slam_tpu/parallel/distributed.py``), on the CPU, at one rank (a world
of one in this process) and at two (two processes in a gloo group through a
``file://`` store under ``tmp_path``); and the multi-device dry run.

Four frames of the room of ``tests/test_torch_registration.py`` (at 4 edge
and 10 surf features a ring sector, where that file takes 8 and 20: the
reference's batched registration in float64 takes ~10 s on the CPU so), each
seen from its own pose against the room's features. The reference is
``register_frames_batched`` evaluated in float64 (``jax.enable_x64``; that
file says why), held at that file's tolerances: pose 1e-5, the counters
exact, ``final_cost`` rtol 1e-4. A frame is registered by the same code
whatever rank registers it, with as many threads, so one rank and two give
equal results.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.backend import pose_graph as jpg
from lmsf_slam_tpu.common import se3 as jse3
from lmsf_slam_tpu.ops import features as jf
from lmsf_slam_tpu.parallel import distributed as jdist
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch
from lmsf_slam_tpu_torch.entry import dryrun_multichip
from lmsf_slam_tpu_torch.ops.registration import RegistrationParams
from lmsf_slam_tpu_torch.parallel import (
    make_mesh,
    multihost,
    register_frames_batched,
    slam_training_step,
)
from tests import torch_ranks
from tests.test_features import synthetic_room_scan
from tests.test_torch_parallel import geo_err, ring_graph
from tests.test_torch_registration import FLAGS, reference_f64
from tests import torch_threads  # noqa: F401

POSES = [  # (rotation vector, translation) of each frame's sensor in the room
    ([0.0, 0.0, 0.05], [0.3, -0.2, 0.05]),
    ([0.01, -0.02, -0.04], [-0.2, 0.25, 0.03]),
    ([0.0, 0.0, 0.1], [0.5, 0.1, 0.0]),
    ([-0.01, 0.01, -0.07], [-0.35, -0.15, 0.02]),
]
STEP_GRAPH = ring_graph(n=16)
STEP_AGREE = 1e-4  # the sharded solve, as tests/test_torch_parallel.py holds it


def room_frames():
    """Room features (the map of every frame) and, for each pose, the room's
    features seen from it; stacked along a frame axis as numpy."""
    src_e, src_s, map_e, map_s, init = [], [], [], [], []
    for seed, (w, t) in enumerate(POSES):
        pb = synthetic_room_scan(noise=0.005, seed=seed)
        feats = jf.extract_loam_features(jf.organize_scan(pb, rings=16, width=360),
                                         edges_per_sector=4, surfs_per_sector=10)
        pose = jse3.make_pose(jse3.so3_exp_quat(jnp.asarray(w, jnp.float32)),
                              jnp.asarray(t, jnp.float32))
        inv = jse3.pose_inverse(pose)
        src_e.append(feats.edge.transform(inv))
        src_s.append(feats.surf.transform(inv))
        map_e.append(feats.edge)
        map_s.append(feats.surf)
        init.append(np.asarray(jse3.pose_identity()))

    def stack(pbs):
        return tuple(np.stack([np.asarray(getattr(p, f)) for p in pbs])
                     for f in ("xyz", "mask", "attr"))

    return {"src_edge": stack(src_e), "src_surf": stack(src_s), "map_edge": stack(map_e),
            "map_surf": stack(map_s), "init_poses": np.stack(init).astype(np.float32)}


@pytest.fixture(scope="module")
def frames():
    return room_frames()


def port_batch(f, name):
    return PointBatch(*(torch.as_tensor(a) for a in f[name]))


def reference_batched(f, params=None):
    """The reference's ``register_frames_batched`` in float64, as numpy."""
    from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
    from lmsf_slam_tpu.ops.registration import RegistrationParams

    pbs = [JPB(*(np.asarray(a) for a in f[k]))
           for k in ("src_edge", "src_surf", "map_edge", "map_surf")]
    return reference_f64(jdist.register_frames_batched, *pbs, f["init_poses"],
                         params=params or RegistrationParams())


@pytest.fixture(scope="module")
def reference(frames):
    return reference_batched(frames)


@pytest.fixture(scope="module")
def two_ranks(frames, tmp_path_factory):
    store = tmp_path_factory.mktemp("store") / "batched"
    return multihost.launch_local(torch_ranks.batched_registration, 2,
                                  args=(frames, STEP_GRAPH), backend="gloo",
                                  init_method=f"file://{store}", timeout=120.0,
                                  threads=torch.get_num_threads())


def assert_frames(got, want, pose_atol=1e-5):
    np.testing.assert_allclose(got["pose"], want.pose, atol=pose_atol, rtol=0)
    for k in FLAGS:
        np.testing.assert_array_equal(got[k].astype(np.int64),
                                      np.asarray(getattr(want, k)).astype(np.int64), err_msg=k)
    np.testing.assert_allclose(got["final_cost"], want.final_cost, rtol=1e-4)


@pytest.mark.parametrize("n_ranks", [1, 2])
def test_register_frames_batched_matches_reference(n_ranks, frames, reference, two_ranks):
    if n_ranks == 1:
        res = register_frames_batched(*(port_batch(frames, k) for k in
                                        ("src_edge", "src_surf", "map_edge", "map_surf")),
                                      torch.as_tensor(frames["init_poses"]),
                                      make_mesh(backend="cpu"))
        got = {k: v.numpy() for k, v in res._asdict().items()}
    else:
        got = two_ranks[0]["batched"]
        np.testing.assert_array_equal(two_ranks[1]["batched"]["pose"], got["pose"])
    assert_frames(got, reference)
    assert got["converged"].all() and (got["n_constrained"] == 6).all()
    # every frame found the pose it was seen from (with half the registration
    # test's features a frame, z of frame 0 lands 0.0204 m off)
    want = np.stack([np.asarray(jse3.make_pose(jse3.so3_exp_quat(jnp.asarray(w, jnp.float32)),
                                               jnp.asarray(t, jnp.float32))) for w, t in POSES])
    np.testing.assert_allclose(got["pose"][:, 4:], want[:, 4:], atol=0.03)


def test_one_rank_and_two_give_equal_poses(frames, two_ranks):
    one = register_frames_batched(*(port_batch(frames, k) for k in
                                    ("src_edge", "src_surf", "map_edge", "map_surf")),
                                  torch.as_tensor(frames["init_poses"]))
    np.testing.assert_array_equal(one.pose.numpy(), two_ranks[0]["batched"]["pose"])
    with pytest.raises(ValueError):  # 4 frames do not divide over 3 ranks
        register_frames_batched(*(port_batch(frames, k) for k in
                                  ("src_edge", "src_surf", "map_edge", "map_surf")),
                                torch.as_tensor(frames["init_poses"]),
                                make_mesh(backend="cpu")._replace(size=3))


def test_slam_training_step_matches_reference(frames, two_ranks):
    """The step's defaults (2 registration iterations; 2 GN × 8 PCG) at two
    ranks and at one: its registration is ``register_frames_batched`` at that
    budget (held against the reference above), its solve the reference's
    sharded solve on ``make_mesh(2)``."""
    reg, poses, stats = two_ranks[0]["step"]
    step = {k: port_batch(frames, k) for k in ("src_edge", "src_surf", "map_edge", "map_surf")}
    step["init_poses"] = torch.as_tensor(frames["init_poses"])
    reg1, poses1, stats1 = slam_training_step(make_mesh(backend="cpu"), step, STEP_GRAPH)
    direct = register_frames_batched(*(step[k] for k in ("src_edge", "src_surf", "map_edge",
                                                         "map_surf")),
                                     step["init_poses"], params=RegistrationParams(max_iters=2))
    for k, v in direct._asdict().items():
        np.testing.assert_array_equal(reg1._asdict()[k].numpy(), v.numpy(), err_msg=k)
        np.testing.assert_array_equal(reg[k], v.numpy(), err_msg=k)
    jo, js = jdist.optimize_pose_graph_sharded(
        *(jnp.asarray(STEP_GRAPH[k]) for k in ("poses", "vmask", "edges_ij", "edges_z",
                                               "edges_sqrtw", "emask")),
        jdist.make_mesh(2, backend="cpu"), params=jpg.PoseGraphParams(gn_iters=2, pcg_iters=8))
    for p in (poses, poses1.numpy()):
        assert geo_err(p, np.asarray(jo)) < STEP_AGREE
    assert stats["iterations"] == int(js.iterations) == int(stats1.iterations)


@pytest.mark.parametrize("n_ranks", [1, 2])
def test_dryrun_multichip_on_the_cpu(n_ranks, tmp_path):
    if n_ranks == 1:
        chi2 = dryrun_multichip(1, device="cpu")
        assert chi2["schur_chi2"][1] < chi2["schur_chi2"][0]
    else:
        assert multihost.launch_local(torch_ranks.dryrun, 2, args=(2,), backend="gloo",
                                      init_method=f"file://{tmp_path / 'store'}",
                                      timeout=120.0, threads=1) == [True, True]
