"""The lifelong deployment's configuration through ``MultiLidarSystem``
(worker thread, probation, carving, the unsupported-point gate, the
occupancy grid) against the reference's system behind the port's tracker, on
the CPU, over the closed course of ``tests/test_torch_lifelong.py``. A file
of its own so that a parallel worker takes it apart from the front end's
tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
from types import SimpleNamespace

from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
from lmsf_slam_tpu.ops import features as jf
from lmsf_slam_tpu.ops import preprocess as jp
from lmsf_slam_tpu_torch.backend import lifelong as pll
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.evaluation import metrics as pmetrics
from lmsf_slam_tpu_torch.system import MultiLidarSystem
from tests.test_torch_lifelong import loop_course
from tests.test_torch_slice import ReferenceSystem, _port_scan, _system_configs


class ReferenceLifelongSystem(ReferenceSystem):
    """``ReferenceSystem`` that also hands the reference's range image to its
    ``_finish_frame`` (dynamic carving needs it) and drains the worker thread
    after every frame, so that what a frame publishes does not depend on how
    the two threads interleave."""

    def __init__(self, jcfg, backend=None):
        super().__init__(jcfg, backend)
        f = jcfg.feature

        @jax.jit
        def front_end(xyz, mask, attr):
            grid = jf.organize_scan(jp.preprocess(JPB(xyz, mask, attr), jcfg.preprocess),
                                    rings=f.rings, width=f.width)
            feats = jf.extract_loam_features(
                grid, sectors=f.sectors, edges_per_sector=f.edges_per_sector,
                surfs_per_sector=f.surfs_per_sector)
            return feats.edge, feats.surf, grid

        self.front_end = front_end

    def process(self, scan, t, frame):
        edge, surf, grid = self.front_end(*map(jnp.asarray, scan))
        out = SimpleNamespace(pose=frame.odom_pose, registration=SimpleNamespace(
            converged=np.bool_(frame.converged), num_matches=np.int32(frame.num_matches)))
        res = self.system._finish_frame(t, out, edge, surf, grid)
        self.system.flush()
        return res


def test_lifelong_deployment_matches_reference_over_the_looped_course():
    """The configuration of the lifelong deployment at the small size:
    ``async_backend`` (policy ``block``, drained after every frame),
    ``dynamic_probation`` (probation and map carving in the port's tracker),
    carving of the 2 nearest stored keyframes, the unsupported-point gate and
    a 64 × 64 occupancy grid, through both systems. Backend decisions are
    equal; keyframe poses to 5e-3 m; carved masks may differ in points within
    rounding of a carving threshold (at most 0.5 % of a keyframe's points);
    the grids differ in at most 3 % of the touched cells once the float32
    reference's poses have been optimized. Frame results: what does not
    depend on the thread interleaving (odometry, gate, convergence) is equal
    on every frame, the map pose on frames that are not keyframes."""
    from lmsf_slam_tpu.mapping import OccupancyConfig as JOcc
    from lmsf_slam_tpu_torch.mapping import OccupancyConfig as POcc

    traj, scans = loop_course()
    occ = dict(size=64, resolution=1.0, samples_per_ray=24)
    extra = dict(dynamic_carve_knn=2, dynamic_gate_unsupported=True)
    kw = dict(async_backend=True, async_policy="block", dynamic_probation=True)
    jcfg, pcfg = _system_configs(**kw)
    jcfg = jcfg._replace(lifelong=jcfg.lifelong._replace(occupancy=JOcc(**occ), **extra))
    pcfg = pcfg._replace(lifelong=pcfg.lifelong._replace(occupancy=POcc(**occ), **extra))
    ref, port = ReferenceLifelongSystem(jcfg), MultiLidarSystem(pcfg, device="cpu")
    assert port.tracker_config.carve_map and port.tracker_config.probation
    carved, carve = [], port.backend.db.carve

    def counting_carve(i, edge_keep, surf_keep):
        db = port.backend.db
        before = int(db.edge_mask[i].sum() + db.surf_mask[i].sum())
        carve(i, edge_keep, surf_keep)
        carved.append(before - int(db.edge_mask[i].sum() + db.surf_mask[i].sum()))

    port.backend.db.carve = counting_carve
    for i, scan in enumerate(scans):
        frame = port.process(_port_scan(scan), 0.1 * i)
        port.flush()
        ref.process(scan, 0.1 * i, frame)
    rs = ref.system
    assert (port._async.dropped, port._async.coalesced, port._async.backlog) == (0, 0, 0)
    jh, ph = rs.backend.history, port.backend.history
    assert [(h.mode.name, h.keyframe_id, bool(h.loop_closed)) for h in ph] == [
        (h.mode.name, h.keyframe_id, bool(h.loop_closed)) for h in jh]
    assert sum(h.loop_closed for h in ph) >= 1 and port.backend.mode is pll.WorkMode.LOCALIZATION
    assert port.backend.solver_runs == rs.backend.solver_runs
    assert len(port.backend.solve_log) == sum(port.backend.solver_runs.values())
    for w, g in zip(rs.results, port.results):
        assert (g.is_keyframe, g.converged, g.num_matches) == (w.is_keyframe, w.converged,
                                                              w.num_matches)
        np.testing.assert_array_equal(g.odom_pose, w.odom_pose)
        if not g.is_keyframe:
            assert g.mode.name == w.mode.name
            np.testing.assert_allclose(g.map_pose, w.map_pose, atol=5e-2)
    jd, pd = rs.backend.db, port.backend.db
    n = jd.n_keyframes
    assert (pd.n_keyframes, pd.n_edges) == (n, jd.n_edges)
    np.testing.assert_array_equal(pd.eij[:pd.n_edges], jd.eij[:jd.n_edges])
    np.testing.assert_allclose(port.keyframe_trajectory(), rs.keyframe_trajectory(), atol=5e-3)
    assert len(carved) > n and sum(carved) > 0  # stored keyframes were carved
    for i in range(n):
        for name in ("edge_mask", "surf_mask"):
            a, b = getattr(pd, name)[i], getattr(jd, name)[i]
            assert (a != b).sum() <= max(1, int(0.005 * a.size)), (i, name)
    m = pd._mirror_sync()
    np.testing.assert_array_equal(m["emk"][:n].numpy(), pd.edge_mask[:n])  # mirror = host masks
    np.testing.assert_array_equal(m["smk"][:n].numpy(), pd.surf_mask[:n])
    jg, pg = np.asarray(rs.occupancy_grid()), port.occupancy_grid().numpy()
    assert (pg > 0).any() and (pg < 0).any() and pg.min() >= -4.0 and pg.max() <= 4.0
    assert (np.abs(pg - jg) > 1e-6).sum() <= 0.03 * (jg != 0).sum()
    assert "kf_hooks" in port.backend.timer.stats() and "loop_detect" in port.backend.timer.stats()
    assert set(port.backend.timer.stats()) - set(rs.backend.timer.stats()) <= {"occ_rebuild"}
    # probation and carving starve the odometry at 16 × 360 (0.35 m here,
    # against 0.1 m without them): a bound on this size, not on the port
    gt = se3np.pose_between(traj[:1], traj)
    assert pmetrics.ate_stats(port.trajectory(), gt).rmse < 0.5
    port._async.close()
    rs._async.close()
