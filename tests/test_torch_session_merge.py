"""The port's multi-session fusion
(``lmsf_slam_tpu_torch.backend.session_merge``) against the reference
(``lmsf_slam_tpu/backend/session_merge.py``) on the case of
``tests/test_session_merge.py`` at a smaller size, on the CPU: two mapping
sessions of one world in different map frames (24 keyframes each, the
middle third shared; 128 edge and 512 surf points a keyframe).

Both packages get the same keyframes (clouds from the reference's synthetic
world, as numpy). Compared: the matches (same (a_id, b_id) pairs, the pose
of each to 5e-2 m), the transform to 5e-2 m and 1e-2 in the quaternion, and
the merged graph: keyframe and edge counts, edge ids and loop marks equal,
stamps and clouds bit-equal, poses and edge measurements to 5e-2 m (they
carry the matches' registrations), edge weights to 1e-5 relative.
"""
import jax
import numpy as np
import pytest

from lmsf_slam_tpu.backend import KeyframeDatabase as JDB
from lmsf_slam_tpu.backend import LifelongBackend as JBackend
from lmsf_slam_tpu.backend import LoopConfig as JLoopConfig
from lmsf_slam_tpu.backend import session_merge as jsm
from lmsf_slam_tpu.datasets import make_trajectory, make_world, scan_at
from lmsf_slam_tpu_torch.backend import KeyframeDatabase as PDB
from lmsf_slam_tpu_torch.backend import LifelongBackend as PBackend
from lmsf_slam_tpu_torch.backend import LoopConfig as PLoopConfig
from lmsf_slam_tpu_torch.backend import session_merge as psm
from lmsf_slam_tpu_torch.common import se3np
from tests.test_torch_registration import to_port
from tests import torch_threads  # noqa: F401

KEY = jax.random.PRNGKey(7)
NE, NS = 128, 512
LOOP = dict(min_frame_interval=20, exclude_recent=20, detect_spacing=1, search_radius=6.0,
            adjacent_window=3, refine_score_thresh=0.3, reloc_score_thresh=0.3)
DB = dict(edge_capacity=NE, surf_capacity=NS, initial_keyframes=8)
OFF_B = np.asarray(se3np.se3_exp(np.array([0, 0, 0.7, 12.0, -5.0, 0.0])), np.float32)


def session(world, poses, frame_offset, seed0):
    """One mapping session in both packages: the same clouds, map poses
    anchored at ``frame_offset`` (sessions must not share a gauge), chain
    edges between consecutive keyframes."""
    j, p = JDB(**DB), PDB(**DB, mirror_min_cap=32, device="cpu")
    prev = None
    for i, pose in enumerate(poses):
        edge, surf = jax.tree.map(np.asarray, scan_at(
            world, pose, jax.random.fold_in(KEY, seed0 + i), n_edge=NE, n_surf=NS, noise=0.01,
            max_range=12.0))
        m = np.asarray(se3np.pose_compose(frame_offset, np.asarray(pose)), np.float32)
        j.add_keyframe(0.1 * i, m, m, edge, surf)
        p.add_keyframe(0.1 * i, m, m, to_port(edge), to_port(surf))
        if prev is not None:
            z = np.asarray(se3np.pose_between(prev, m), np.float32)
            j.add_edge(i - 1, i, z)
            p.add_edge(i - 1, i, z)
        prev = m
    return j, p


@pytest.fixture(scope="module")
def two_sessions():
    world = make_world(KEY, extent=25.0, n_pillars=50, n_ground=5000, n_wall=2500)
    traj = np.asarray(make_trajectory(36, radius=10.0, loop=True))
    ja, pa = session(world, traj[:24], se3np.pose_identity(), 0)
    jb, pb = session(world, traj[12:36], OFF_B, 1000)
    return (ja, jb), (pa, pb), traj


def test_align_and_merge_match_reference(two_sessions):
    (ja, jb), (pa, pb), traj = two_sessions
    want = jsm.align_sessions(ja, jb, JLoopConfig(**LOOP))
    got = psm.align_sessions(pa, pb, PLoopConfig(**LOOP))
    assert want is not None and got is not None, "no alignment found"
    assert got.n_tried == want.n_tried == 24
    assert [(a, b) for a, b, _ in got.matches] == [(a, b) for a, b, _ in want.matches]
    assert len(got.matches) >= 3
    for (_, _, x), (_, _, y) in zip(got.matches, want.matches):
        np.testing.assert_allclose(x[4:], y[4:], atol=5e-2)
    np.testing.assert_allclose(got.transform[4:], want.transform[4:], atol=5e-2)
    assert min(np.abs(got.transform[:4] - want.transform[:4]).max(),
               np.abs(got.transform[:4] + want.transform[:4]).max()) < 1e-2
    # T_A←B inverts session B's frame offset
    err = se3np.pose_between(got.transform, se3np.pose_inverse(OFF_B))
    assert np.linalg.norm(se3np.pose_trans(err)) < 0.3
    assert np.linalg.norm(se3np.so3_log(se3np.pose_quat(err))) < np.radians(2.0)

    n_a, e_a, n_b, e_b = pa.n_keyframes, pa.n_edges, pb.n_keyframes, pb.n_edges
    assert jsm.merge_sessions(ja, jb, want) == psm.merge_sessions(pa, pb, got) == n_a
    n, e = pa.n_keyframes, pa.n_edges
    assert (n, e) == (n_a + n_b, e_a + e_b + len(got.matches)) == (ja.n_keyframes, ja.n_edges)
    np.testing.assert_array_equal(pa.eij[:e], ja.eij[:e])
    np.testing.assert_array_equal(pa.eloop[:e], ja.eloop[:e])
    assert pa.eloop[e_a + e_b:e].all() and not pa.eloop[:e_a + e_b].any()  # inter-session = loop
    assert (pa.eij[e_a + e_b:e, 0] < n_a).all() and (pa.eij[e_a + e_b:e, 1] >= n_a).all()
    for name in ("stamps", "odom_poses", "edge_xyz", "edge_mask", "surf_xyz", "surf_mask", "sc",
                 "gnss_valid"):
        np.testing.assert_array_equal(getattr(pa, name)[:n], getattr(ja, name)[:n], err_msg=name)
    np.testing.assert_allclose(pa.ring_keys[:n], ja.ring_keys[:n], atol=1e-6)
    np.testing.assert_allclose(pa.map_poses[:n, 4:], ja.map_poses[:n, 4:], atol=5e-2)
    np.testing.assert_allclose(pa.ez[:e, 4:], ja.ez[:e, 4:], atol=5e-2)
    np.testing.assert_allclose(pa.ez[:e_a + e_b], ja.ez[:e_a + e_b], atol=1e-5)  # re-indexed only
    np.testing.assert_allclose(pa.esqrtw[:e], ja.esqrtw[:e], rtol=1e-5)
    # merged B keyframes land on their true world positions
    gt_b = traj[12:36, 4:]
    assert np.linalg.norm(pa.map_poses[n_a:n, 4:] - gt_b, axis=1).max() < 0.5
    # the merged graph optimizes without blowing up, in both packages alike
    ps = PBackend(db=pa, mode=None).force_global_optimize()
    js = JBackend(db=ja, mode=None).force_global_optimize()
    assert float(ps.chi2_final) <= float(ps.chi2_initial) + 1e-3
    assert np.isfinite(pa.map_poses[:n]).all()
    np.testing.assert_allclose(pa.map_poses[:n, 4:], ja.map_poses[:n, 4:], atol=5e-2)
    assert abs(float(ps.chi2_final) - float(js.chi2_final)) <= 0.2 * float(js.chi2_final) + 1.0
    assert np.linalg.norm(pa.map_poses[n_a:n, 4:] - gt_b, axis=1).max() < 0.6


def test_too_few_matches_give_no_alignment(two_sessions):
    """Sessions that share no place: no alignment in either package."""
    (ja, _), (pa, _), _ = two_sessions
    far_world = make_world(jax.random.PRNGKey(99), extent=25.0, n_pillars=40, n_ground=3000,
                           n_wall=1500)
    traj = np.asarray(make_trajectory(6, radius=7.0, loop=False))
    jc, pc = session(far_world, traj, se3np.pose_identity(), 5000)
    strict = dict(LOOP, reloc_score_thresh=0.01, refine_score_thresh=0.01)
    assert jsm.align_sessions(ja, jc, JLoopConfig(**strict)) is None
    assert psm.align_sessions(pa, pc, PLoopConfig(**strict)) is None
    assert psm.SessionAlignment._fields == jsm.SessionAlignment._fields
