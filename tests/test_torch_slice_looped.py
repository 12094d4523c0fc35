"""``MultiLidarSystem.process`` over the closed course of
``tests/test_torch_lifelong.py`` against the reference's system behind the
port's tracker (``tests/test_torch_slice.py::ReferenceSystem``), on the
CPU: the sync lifelong backend's decisions, the system's exports, and a
reboot on the reference's database. A file of its own so that a parallel
worker takes it apart from the front end's tests.
"""
import numpy as np
import pytest

from lmsf_slam_tpu.backend import lifelong as jll
from lmsf_slam_tpu_torch.backend import lifelong as pll
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.evaluation import metrics as pmetrics
from lmsf_slam_tpu_torch.system import MultiLidarSystem
from tests.test_torch_lifelong import carry_database, loop_course
from tests.test_torch_slice import ReferenceSystem, _run_both, _system_configs, assert_same_frames


@pytest.fixture(scope="module")
def looped_run():
    traj, scans = loop_course()
    jcfg, pcfg = _system_configs()
    ref, port = ReferenceSystem(jcfg), MultiLidarSystem(pcfg, device="cpu")
    _run_both(ref, port, scans, [0.1 * i for i in range(len(scans))])
    return ref.system, port, traj, scans


def test_multilidar_system_matches_reference_over_a_looped_course(looped_run):
    ref, port, traj, _ = looped_run
    assert_same_frames(ref.results, port.results)
    jh, ph = ref.backend.history, port.backend.history
    assert [(h.mode.name, h.keyframe_id, bool(h.loop_closed)) for h in ph] == [
        (h.mode.name, h.keyframe_id, bool(h.loop_closed)) for h in jh]
    assert sum(h.loop_closed for h in ph) >= 1
    assert port.backend.mode is pll.WorkMode.LOCALIZATION
    assert port.backend.solver_runs == ref.backend.solver_runs
    jd, pd = ref.backend.db, port.backend.db
    assert (pd.n_keyframes, pd.n_edges) == (jd.n_keyframes, jd.n_edges)
    np.testing.assert_array_equal(pd.eij[:pd.n_edges], jd.eij[:jd.n_edges])  # the loop edge ids
    np.testing.assert_array_equal(pd.eloop[:pd.n_edges], jd.eloop[:jd.n_edges])
    np.testing.assert_array_equal(pd.edge_mask[:pd.n_keyframes], jd.edge_mask[:jd.n_keyframes])
    np.testing.assert_allclose(port.trajectory(), ref.trajectory(), atol=5e-2)
    np.testing.assert_allclose(port.keyframe_trajectory(), ref.keyframe_trajectory(), atol=5e-3)
    gt = se3np.pose_between(traj[:1], traj)
    assert pmetrics.ate_stats(port.trajectory(), gt).rmse < 0.2


def test_system_exports(looped_run):
    ref, port, _, _ = looped_run
    assert port.trajectory().shape == (len(port.results), 7)
    pts = port.global_map(voxel_size=0.5)
    want = ref.global_map(voxel_size=0.5)
    assert pts.ndim == 2 and pts.shape[1] == 3 and np.isfinite(pts).all()
    assert abs(pts.shape[0] - want.shape[0]) <= 0.02 * want.shape[0]
    assert port.flush() is None
    assert port.calib_status == 2 and port.extrinsics == []
    empty = MultiLidarSystem(_system_configs()[1], device="cpu")
    assert empty.trajectory().shape == (0, 7) and empty.global_map().shape == (0, 3)
    assert empty.force_global_optimize() is None
    with pytest.raises(ValueError, match="expected 1 scans"):
        empty.process([None, None], 0.0)


def test_reboot_through_the_system_relocalizes_like_the_reference(looped_run):
    """A second run on the first one's database (the reference's, carried
    across with ``keyframe_db_from_numpy``): both systems boot in
    RELOCALIZATION with a fresh tracker, are fed the course from its 12th
    frame, relocalize on the same frame and report map poses in the first
    run's frame."""
    ref, _, traj, scans = looped_run
    jcfg, pcfg = _system_configs()
    jb = jll.LifelongBackend(db=ref.backend.db, config=jcfg.lifelong, loop_config=jcfg.loop)
    pb = pll.LifelongBackend(db=carry_database(ref.backend.db), config=pcfg.lifelong,
                             loop_config=pcfg.loop)
    assert pb.mode is pll.WorkMode.RELOCALIZATION
    ref2, port2 = ReferenceSystem(jcfg, backend=jb), MultiLidarSystem(pcfg, backend=pb, device="cpu")
    start = 12
    _run_both(ref2, port2, scans[start:start + 8], [100.0 + 0.1 * i for i in range(8)])
    assert_same_frames(ref2.system.results, port2.results)
    modes = [r.mode for r in port2.results]
    assert modes[0] is pll.WorkMode.LOCALIZATION  # the first keyframe relocalizes
    gt = se3np.pose_between(traj[0], traj[start:start + 8])
    err = np.linalg.norm(port2.trajectory()[:, 4:] - gt[:, 4:], axis=1)
    assert err.max() < 0.5  # the map itself is ~0.15 m ATE at this coarse size
