"""The port's ICP method of ``MultiLidarSystem``
(``registration_method="sparse_point_plane_icp"``) against the reference, on
the CPU, on ``tests/test_system.py::test_system_sparse_point_plane_icp``'s
scenario (its ``small_config``: 16 × 360 scans, 1152 surf points a frame,
``icp_voxel_size=0.5``) with the port's simulator, numpy-seeded, giving both
packages the same scans.

Each frame of the port's system (preprocess → voxel downsample →
``tracker_step``, one read-back) is held to the reference's own
``MultiLidarSystem.featurize`` (the ICP surf cloud bit-equal) and to the
reference's ``tracker_step`` on those features evaluated in float64 (pose
within 1e-4 m / 1e-4 rad, registration flags equal), as the port's other
tracker tests are; and the reference's own float32 system over the same
frames takes the same keyframe decisions, its poses within 1e-2 m (the
float32 reference's ill-conditioning on ring scans, ``ROADMAP.md`` standing
notes: measured 2e-3 m over these frames). The port alone over the test's
20 frames, held to its 0.25 m ATE bound, is in
``tests/test_torch_icp_course.py`` (a file of its own, so that parallel
workers can take the two apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.backend import LoopConfig as JLoopConfig
from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
from lmsf_slam_tpu.ops.registration import RegistrationParams as JRP
from lmsf_slam_tpu.system import ml_system as jsys
from lmsf_slam_tpu.tracker import tracker as jt
from lmsf_slam_tpu_torch.backend import LoopConfig as PLoopConfig
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch as PPB
from lmsf_slam_tpu_torch.system import ml_system as psys
from tests import torch_threads  # noqa: F401
from tests.test_torch_slice import _reference_tracker_config
from tests.test_torch_tracker import reference_step64, sim_course, widen_state

N_COMPARED = 3
ICP = dict(registration_method="sparse_point_plane_icp", icp_voxel_size=0.5)


def small_configs(**kw):
    """``tests/test_system.py::small_config`` in both packages."""
    d = dict(tracker_window=8, map_update_trans=0.2, keyframe_trans=0.8, **ICP, **kw)
    feat = dict(rings=16, width=360, edges_per_sector=4, surfs_per_sector=12)
    reg = dict(max_iters=8, max_corr_dist=2.0)
    return (jsys.SystemConfig(feature=jsys.FeatureParams(**feat), registration=JRP(**reg),
                              loop=JLoopConfig(min_frame_interval=1000), **d),
            psys.SystemConfig(feature=psys.FeatureParams(**feat),
                              registration=psys.RegistrationParams(**reg),
                              loop=PLoopConfig(min_frame_interval=1000), **d))


@pytest.fixture(scope="module")
def course():
    return sim_course(N_COMPARED, width=360)


def _port_scan(scan):
    return PPB(*(torch.as_tensor(a) for a in scan))


def test_icp_frames_match_reference(course):
    traj, scans = course
    jcfg, pcfg = small_configs()
    port = psys.MultiLidarSystem(pcfg, device="cpu")
    featurize = psys.build_featurize(pcfg, "cpu")
    ref = jsys.MultiLidarSystem(jcfg)
    jtc = _reference_tracker_config(port.tracker_config)
    state64 = widen_state(jt.tracker_init(jtc))
    for i, scan in enumerate(scans[:N_COMPARED]):
        t = 0.1 * i
        edge, surf, grid = jax.tree.map(np.asarray, ref.featurize(JPB(*map(jnp.asarray, scan))))
        p_edge, p_surf, p_grid = featurize(*scan)
        assert grid is None and p_grid is None  # no carving: no range image
        assert not p_edge.mask.any() and p_edge.capacity == pcfg.feature.edge_capacity
        for k in ("xyz", "mask", "attr"):
            np.testing.assert_array_equal(getattr(p_surf, k).numpy(), getattr(surf, k), err_msg=k)
        assert 500 < int(p_surf.mask.sum()) <= pcfg.feature.surf_capacity

        got = port.process(_port_scan(scan), t)
        state64, want = reference_step64(state64, edge, surf, t, jtc)
        out = port.results[-1]
        _assert_pose(got.odom_pose, want.pose, i)
        assert got.num_matches == int(want.registration.num_matches), i
        assert got.converged == bool(want.registration.converged), i
        np.testing.assert_array_equal(out.map_pose, got.map_pose)

        w = ref.process(JPB(*map(jnp.asarray, scan)), t)
        assert (got.is_keyframe, got.keyframe_id, got.mode.name) == (
            w.is_keyframe, w.keyframe_id, w.mode.name), i
        np.testing.assert_allclose(got.odom_pose, w.odom_pose, atol=1e-2, err_msg=str(i))


def _assert_pose(got, want, i):
    d = se3np.pose_between(np.asarray(want, np.float64), np.asarray(got, np.float64))
    assert np.linalg.norm(se3np.pose_trans(d)) < 1e-4, (i, d)
    assert np.linalg.norm(se3np.so3_log(se3np.pose_quat(d))) < 1e-4, (i, d)


def test_icp_organizes_a_range_image_only_for_carving():
    """With the backend's carving on, the ICP frame organizes the range
    image (the reference's ``featurize``); the two-LiDAR and IMU-aided
    systems featurize each scan the same way."""
    _, pcfg = small_configs()
    carve = pcfg._replace(lifelong=pcfg.lifelong._replace(dynamic_carve_knn=3))
    _, scans = sim_course(1, width=360)
    edge, surf, grid = psys.build_featurize(carve, "cpu")(*scans[0])
    assert grid is not None and tuple(grid.xyz.shape[:2]) == (16, 360)
    for cfg in (pcfg._replace(n_lidars=2), pcfg._replace(use_imu=True)):
        system = psys.MultiLidarSystem(cfg, device="cpu")
        e, s, g = system.featurize(_port_scan(scans[0]))
        assert g is None and not e.mask.any()
        np.testing.assert_array_equal(s.xyz.numpy(), surf.xyz.numpy())
