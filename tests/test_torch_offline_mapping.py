"""The port's sequence-sharded offline mapping
(``lmsf_slam_tpu_torch.parallel.offline_mapping``) at four ranks on the CPU
(four processes in a gloo group through a ``file://`` store under
``tmp_path``), on a short course in the world of
``tests/test_offline_mapping.py`` (extent 18 m, 18 boxes, 40 cylinders, a
clear radius of 3 m; 16 × 360 scans to 40 m; that test's tracker settings):
the first 16 frames of its 32-frame half-arc of 7 m, in four chunks of four.

Held to the reference test's bounds (ATE under 0.25 m, at most one stitch
short of converged: here C − 2), every chunk starting at identity, and the
same chunks tracked, stitched and composed in this process within 1e-5 m
(the ranks run as many torch threads as this process, so the same float32
sums). The reference's tracker in float64 takes seconds a frame here, so the
reference is held where the two share arithmetic: the composition of chunk
offsets, against its ``se3.pose_compose``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.common import se3 as jse3
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch
from lmsf_slam_tpu_torch.datasets import make_sim_world, make_trajectory, simulate_scan
from lmsf_slam_tpu_torch.evaluation import ate_stats
from lmsf_slam_tpu_torch.ops import features as F
from lmsf_slam_tpu_torch.ops.registration import RegistrationParams, register_edge_surf
from lmsf_slam_tpu_torch.parallel import multihost
from lmsf_slam_tpu_torch.parallel.offline_mapping import _compose_chunks, _track_chunk
from lmsf_slam_tpu_torch.tracker import TrackerConfig
from tests import torch_ranks
from tests import torch_threads  # noqa: F401

N_FRAMES = 16
CHUNKS = 4
ATE_LIMIT = 0.25  # m, tests/test_offline_mapping.py
AGREE = 1e-5


def course():
    """Ground truth (F, 7), feature scans as numpy (xyz, mask, attr) stacked
    along the frame axis, timestamps, and the tracker's configuration."""
    rng = np.random.default_rng(44)
    world = make_sim_world(rng, extent=18.0, n_boxes=18, n_cylinders=40, clear_radius=3.0)
    traj = make_trajectory(32, radius=7.0, loop=False, device="cpu").numpy()[:N_FRAMES].copy()
    traj[:, 6] = 1.3
    edges, surfs = [], []
    for i in range(N_FRAMES):
        pb = simulate_scan(world, traj[i], rng, rings=16, width=360, max_range=40.0,
                           noise=0.01, device="cpu")
        f = F.extract_loam_features(F.organize_scan(pb, rings=16, width=360),
                                    edges_per_sector=6, surfs_per_sector=12)
        edges.append(f.edge)
        surfs.append(f.surf)

    def stack(pbs):
        return tuple(torch.stack([getattr(p, k) for p in pbs]).numpy()
                     for k in ("xyz", "mask", "attr"))

    edge, surf = stack(edges), stack(surfs)
    config = TrackerConfig(window=8, edge_capacity=edge[0].shape[1],
                           surf_capacity=surf[0].shape[1], map_update_trans=0.15,
                           registration=RegistrationParams(max_iters=8, max_corr_dist=2.0))
    stamps = (np.arange(N_FRAMES) * 0.1).astype(np.float32)
    return traj, edge, surf, stamps, config


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    traj, edge, surf, stamps, config = course()
    store = tmp_path_factory.mktemp("store") / "offline"
    results = multihost.launch_local(torch_ranks.offline_map, CHUNKS,
                                     args=(edge, surf, stamps, config), backend="gloo",
                                     init_method=f"file://{store}", timeout=180.0,
                                     threads=torch.get_num_threads())
    return traj, edge, surf, stamps, config, results


def one_process(edge, surf, stamps, config):
    """The same chunks tracked, stitched and composed here, in order:
    (global poses, chunk poses, stitch poses, stitch converged)."""
    L = N_FRAMES // CHUNKS
    stitch_params = config.registration._replace(max_corr_dist=2.0, max_iters=16)
    outs = []
    for c in range(CHUNKS):
        s = slice(c * L, (c + 1) * L)
        outs.append(_track_chunk(*(torch.as_tensor(a[s]) for a in (edge[0], edge[1], surf[0],
                                                                     surf[1], stamps)),
                                 torch.as_tensor(se3np.pose_identity(), dtype=torch.float32),
                                 config, torch.device("cpu")))
    stitch, conv = [], []
    for c in range(1, CHUNKS):
        prev = outs[c - 1]
        first = c * L
        reg = register_edge_surf(
            PointBatch(torch.as_tensor(edge[0][first]), torch.as_tensor(edge[1][first])),
            PointBatch(torch.as_tensor(surf[0][first]), torch.as_tensor(surf[1][first])),
            PointBatch(prev[1], prev[2]), PointBatch(prev[3], prev[4]),
            torch.as_tensor(np.float32(se3np.pose_compose(prev[5].numpy(), prev[6].numpy()))),
            stitch_params)
        stitch.append(reg.pose.numpy())
        conv.append(bool(reg.converged))
    chunk_poses = np.stack([o[0].numpy() for o in outs])
    stitch = np.stack(stitch)
    return _compose_chunks(chunk_poses, stitch), chunk_poses, stitch, np.asarray(conv)


def test_offline_sharded_mapping_tracks_ground_truth(run):
    traj, *_, results = run
    res = results[0]
    for other in results[1:]:  # every rank returns the same result
        for k, v in res.items():
            np.testing.assert_array_equal(other[k], v)
    assert res["poses"].shape == (N_FRAMES, 7)
    assert res["chunk_poses"].shape == (CHUNKS, N_FRAMES // CHUNKS, 7)
    assert res["stitch_converged"].sum() >= CHUNKS - 2
    gt_rel = se3np.pose_between(traj[0], traj)
    assert ate_stats(res["poses"], gt_rel, align=True).rmse < ATE_LIMIT
    # chunk-local trajectories each start at identity
    np.testing.assert_allclose(res["chunk_poses"][:, 0, 4:], 0.0, atol=AGREE)
    np.testing.assert_allclose(np.abs(res["chunk_poses"][:, 0, 0]), 1.0, atol=AGREE)


def test_offline_mapping_equals_one_process(run):
    _, edge, surf, stamps, config, results = run
    poses, chunk_poses, stitch, conv = one_process(edge, surf, stamps, config)
    res = results[0]
    np.testing.assert_allclose(res["chunk_poses"], chunk_poses, atol=AGREE, rtol=0)
    np.testing.assert_allclose(res["poses"], poses, atol=AGREE, rtol=0)
    np.testing.assert_array_equal(res["stitch_converged"], conv)

    # the composition, against the reference's (offline_mapping.py:153-177)
    offsets = [jse3.pose_identity()]
    for c in range(CHUNKS - 1):
        offsets.append(jse3.pose_compose(offsets[-1], jnp.asarray(stitch[c])))
    want = jax.vmap(lambda off, tr: jax.vmap(lambda p: jse3.pose_compose(off, p))(tr))(
        jnp.stack(offsets), jnp.asarray(chunk_poses))
    np.testing.assert_allclose(poses, np.asarray(want).reshape(-1, 7), atol=AGREE, rtol=0)
