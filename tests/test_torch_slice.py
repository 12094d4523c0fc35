"""The port's front-end frame as a whole: ``build_fused_step`` (preprocess →
organize → LOAM features → ``tracker_step``) with the keyframe gate, against
the reference composing the same public functions as its fused step
(``lmsf_slam_tpu/system/ml_system.py``, ``_build_fused_step``), on the CPU.

Small size: 16 rings × 360 columns, 192 edge and 768 surf features, a window
of 4 scans. Front end: features bit-identical each frame (the same float32
formulas, no reduction across points). Tracker: the reference evaluated in
float64, as in ``tests/test_torch_tracker.py``; pose within 1e-4 m and
1e-4 rad a frame, ``map_updated`` identical. Keyframe decisions identical.

The slice as a whole is ``MultiLidarSystem.process`` over the closed course
of ``tests/test_torch_lifelong.py``. The reference side is the reference's
own ``MultiLidarSystem`` behind the port's tracker (see ``ReferenceSystem``):
its front end, its ``_finish_frame`` (keyframe gate, float32 lifelong
backend, FrameResult) as it ships. Decisions are compared exactly; poses at
the tolerances of that file (1e-4 m while mapping, 5e-2 m once the float32
reference localizes).
"""
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
from lmsf_slam_tpu.evaluation import metrics as jmetrics
from lmsf_slam_tpu.ops import features as jf
from lmsf_slam_tpu.ops import preprocess as jp
from lmsf_slam_tpu.ops.registration import RegistrationParams as JRP
from lmsf_slam_tpu.system import ml_system as jsys
from lmsf_slam_tpu.tracker import tracker as jt
from lmsf_slam_tpu.backend import lifelong as jll
from lmsf_slam_tpu.backend import loop_closure as jlc
from lmsf_slam_tpu.system import config as jconfig
from lmsf_slam_tpu.utils.profiling import StageTimer as JStageTimer
from lmsf_slam_tpu_torch.backend import lifelong as pll
from lmsf_slam_tpu_torch.backend import loop_closure as plc
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch as PPB
from lmsf_slam_tpu_torch.system import MultiLidarSystem
from lmsf_slam_tpu_torch.system import config as pconfig
from lmsf_slam_tpu_torch.utils.profiling import StageTimer
from lmsf_slam_tpu_torch.evaluation import metrics as pmetrics
from lmsf_slam_tpu_torch.system import ml_system as psys
from lmsf_slam_tpu_torch.tracker import tracker_init
from tests.test_torch_lifelong import LIFELONG, LOOP, carry_database, loop_course
from tests.test_torch_tracker import assert_frame, reference_step64, sim_course, widen_state

N_FRAMES = 6
FEATURE = dict(rings=16, width=360, edges_per_sector=2, surfs_per_sector=8)


def _configs():
    kw = dict(tracker_window=4, map_update_trans=0.3)
    return (jsys.SystemConfig(feature=jsys.FeatureParams(**FEATURE), **kw),
            psys.SystemConfig(feature=psys.FeatureParams(**FEATURE), **kw))


def _reference_tracker_config(tc):
    """The reference's TrackerConfig with the port-derived values (the
    reference derives it inside ``MultiLidarSystem.__init__``)."""
    d = tc._asdict()
    d["registration"] = JRP(**tc.registration._asdict())
    return jt.TrackerConfig(**d)


def test_fused_step_matches_reference():
    jcfg, pcfg = _configs()
    traj, scans = sim_course(N_FRAMES)
    tc, step = psys.build_fused_step(pcfg, device="cpu")
    jtc = _reference_tracker_config(tc)
    f = jcfg.feature

    @jax.jit
    def reference_front_end(xyz, mask, attr):
        grid = jf.organize_scan(jp.preprocess(JPB(xyz, mask, attr), jcfg.preprocess),
                                rings=f.rings, width=f.width)
        feats = jf.extract_loam_features(
            grid, sectors=f.sectors, edges_per_sector=f.edges_per_sector,
            surfs_per_sector=f.surfs_per_sector, edge_thresh=f.edge_thresh,
            surf_thresh=f.surf_thresh, nms_half=f.nms_half, range_noise=f.range_noise,
            exclude_ground_edges=f.exclude_ground_edges,
            one_sided_occlusion=f.one_sided_occlusion,
        )
        return feats.edge, feats.surf

    gate_args = (pcfg.keyframe_trans, pcfg.keyframe_rot, pcfg.keyframe_dt)
    pgate, jgate = psys.KeyframeGate(*gate_args), jsys.KeyframeGate(*gate_args)
    state = tracker_init(tc, device="cpu")
    ref = widen_state(jt.tracker_init(jtc))
    poses = []
    for i, (xyz, mask, attr) in enumerate(scans):
        t = 0.1 * i
        state, out, edge, surf, _ = step(state, xyz, mask, attr, t)
        j_edge, j_surf = jax.tree.map(np.asarray, reference_front_end(xyz, mask, attr))
        for got, want in ((edge, j_edge), (surf, j_surf)):
            np.testing.assert_array_equal(got.mask.numpy(), want.mask)
            np.testing.assert_array_equal(got.xyz.numpy(), want.xyz)
        ref, want = reference_step64(ref, j_edge, j_surf, t, jtc)
        assert_frame(out, want, i)
        res = psys.read_frame(out, pgate, t)
        assert res.is_keyframe == jgate.need_update(np.asarray(want.pose, np.float32), t)
        assert res.num_matches == int(want.registration.num_matches)
        assert res.converged == bool(want.registration.converged)
        np.testing.assert_array_equal(res.map_pose, res.odom_pose)
        poses.append(res.odom_pose)
    assert pgate.accum_distance == pytest.approx(jgate.accum_distance, abs=1e-4)
    gt = se3np.pose_between(traj[:1], traj)
    assert pmetrics.ate_stats(np.stack(poses), gt).rmse < 0.15  # tests/test_system.py's bound


def test_tracker_config_is_derived_as_the_reference_derives_it():
    _, pcfg = _configs()
    pcfg = pcfg._replace(deskew=True, dynamic_probation=True, n_lidars=1)
    tc = psys.tracker_config_for(pcfg)
    f = pcfg.feature
    assert (tc.window, tc.edge_capacity, tc.surf_capacity) == (4, f.edge_capacity, f.surf_capacity)
    assert tc.deskew and tc.probation and tc.carve_map
    assert (tc.map_update_trans, tc.map_update_rot, tc.map_update_dt) == (
        pcfg.map_update_trans, pcfg.map_update_rot, pcfg.map_update_dt)


def test_front_end_config_defaults_match_reference():
    assert psys.FeatureParams()._asdict() == jsys.FeatureParams()._asdict()
    assert psys.FeatureParams().edge_capacity == jsys.FeatureParams().edge_capacity
    assert psys.FeatureParams().surf_capacity == jsys.FeatureParams().surf_capacity
    want, got = jsys.SystemConfig(), psys.SystemConfig()
    for name in psys.SystemConfig._fields:
        w, g = getattr(want, name), getattr(got, name)
        if hasattr(w, "_asdict"):
            assert g._asdict() == w._asdict(), name
        else:
            assert g == w, name


def test_build_fused_step_serves_only_the_fused_path():
    _, pcfg = _configs()
    for bad in (pcfg._replace(n_lidars=2), pcfg._replace(registration_method="ndt")):
        with pytest.raises(ValueError, match="fused step"):
            psys.build_fused_step(bad, device="cpu")


def test_keyframe_gate_matches_reference():
    rng = np.random.default_rng(4)
    yaw = np.cumsum(rng.normal(0.0, 0.15, 60))
    xy = np.cumsum(rng.normal(0.0, 0.4, (60, 2)), axis=0)
    poses = np.zeros((60, 7), np.float32)
    poses[:, 0], poses[:, 3] = np.cos(yaw / 2), np.sin(yaw / 2)
    poses[:, 4:6] = xy
    args = (1.0, math.radians(30.0), 2.0)
    pg, jg = psys.KeyframeGate(*args), jsys.KeyframeGate(*args)
    stamps = np.cumsum(rng.uniform(0.05, 0.6, 60))
    decisions = [(pg.need_update(p, t), jg.need_update(p, t)) for p, t in zip(poses, stamps)]
    assert all(a == b for a, b in decisions)
    assert 5 < sum(a for a, _ in decisions) < 60
    assert pg.accum_distance == pytest.approx(jg.accum_distance, rel=1e-12)


@pytest.mark.parametrize("align", [True, False])
def test_ate_matches_reference(align):
    rng = np.random.default_rng(5)
    gt = np.zeros((40, 7))
    gt[:, 0] = 1.0
    gt[:, 4:] = np.cumsum(rng.normal(size=(40, 3)), axis=0)
    est = gt.copy()
    c, s = math.cos(0.3), math.sin(0.3)
    est[:, 4:] = gt[:, 4:] @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T + [1.0, -2.0, 0.5]
    est[:, 4:] += rng.normal(scale=0.05, size=(40, 3))
    want = jmetrics.ate_stats(est, gt, align=align)
    got = pmetrics.ate_stats(est, gt, align=align)
    np.testing.assert_allclose(tuple(got), tuple(want), rtol=1e-12)
    R, t, sc = pmetrics.umeyama_alignment(est[:, 4:], gt[:, 4:], with_scale=True)
    Rj, tj, scj = jmetrics.umeyama_alignment(est[:, 4:], gt[:, 4:], with_scale=True)
    np.testing.assert_allclose(R, Rj, atol=1e-12)
    np.testing.assert_allclose(t, tj, atol=1e-12)
    assert sc == pytest.approx(scj, rel=1e-12)


# ---------------------------------------------------------------------------
# the slice as a whole: MultiLidarSystem.process
# ---------------------------------------------------------------------------

SYSTEM = dict(tracker_window=6, map_update_trans=0.2, keyframe_trans=0.8)
REG = dict(max_iters=8, max_corr_dist=2.0)


def _system_configs(**kw):
    kw = {**SYSTEM, **kw}
    j = jsys.SystemConfig(feature=jsys.FeatureParams(**FEATURE), registration=JRP(**REG),
                          lifelong=jll.LifelongConfig(**LIFELONG), loop=jlc.LoopConfig(**LOOP), **kw)
    p = psys.SystemConfig(feature=psys.FeatureParams(**FEATURE),
                          registration=psys.RegistrationParams(**REG),
                          lifelong=pll.LifelongConfig(**LIFELONG), loop=plc.LoopConfig(**LOOP), **kw)
    return j, p


class ReferenceSystem:
    """The reference's ``MultiLidarSystem`` behind the port's tracker.

    The reference's float64 ``tracker_step`` takes 3–12 s a frame on the CPU,
    and ``test_fused_step_matches_reference`` above already holds the port's
    tracker to it (1e-4 m a frame). So here each frame runs the reference's
    own front end (features asserted bit-equal to the port's), takes the
    tracked pose, convergence flag and match count from the port's frame,
    and hands them to the reference system's own ``_finish_frame``: its
    keyframe gate, its float32 lifelong backend and its FrameResult, as they
    ship."""

    def __init__(self, jcfg, backend=None):
        self.system = jsys.MultiLidarSystem(jcfg, backend=backend)
        f = jcfg.feature

        @jax.jit
        def front_end(xyz, mask, attr):
            grid = jf.organize_scan(jp.preprocess(JPB(xyz, mask, attr), jcfg.preprocess),
                                    rings=f.rings, width=f.width)
            feats = jf.extract_loam_features(
                grid, sectors=f.sectors, edges_per_sector=f.edges_per_sector,
                surfs_per_sector=f.surfs_per_sector)
            return feats.edge, feats.surf

        self.front_end = front_end

    def process(self, scan, t, frame):
        edge, surf = self.front_end(*map(jnp.asarray, scan))
        out = SimpleNamespace(pose=frame.odom_pose, registration=SimpleNamespace(
            converged=np.bool_(frame.converged), num_matches=np.int32(frame.num_matches)))
        return self.system._finish_frame(t, out, edge, surf, None)


def _run_both(ref, port, scans, stamps):
    for scan, t in zip(scans, stamps):
        frame = port.process(_port_scan(scan), t)
        ref.process(scan, t, frame)


def _port_scan(scan):
    return PPB(*(torch.as_tensor(a) for a in scan))


def assert_same_frames(want, got):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert (g.mode.name, g.is_keyframe, g.keyframe_id, g.loop_closed, g.converged,
                g.calib_status) == (w.mode.name, w.is_keyframe, w.keyframe_id, w.loop_closed,
                                    w.converged, w.calib_status), i
        np.testing.assert_allclose(g.odom_pose, w.odom_pose, atol=1e-4, err_msg=str(i))
        tol = 1e-4 if g.mode is pll.WorkMode.MAPPING and not g.loop_closed else 5e-2
        np.testing.assert_allclose(g.map_pose, w.map_pose, atol=tol, err_msg=str(i))


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


def test_unported_system_paths_are_rejected(tmp_path):
    _, pcfg = _system_configs()
    for bad, item in ((dict(n_lidars=2), "item 13"), (dict(use_imu=True), "item 12"),
                      (dict(registration_method="sparse_point_plane_icp"), "item 14")):
        with pytest.raises(NotImplementedError, match=item):
            MultiLidarSystem(pcfg._replace(**bad), device="cpu")
    # what raised before it was ported now runs: the worker-thread backend,
    # save and load (the database lands on the device that load names)
    system = MultiLidarSystem(pcfg._replace(async_backend=True), device="cpu")
    assert system._async is not None and system._pending_gnss is None
    path = str(tmp_path / "x.npz")
    system.save(path)
    loaded = MultiLidarSystem.load(path, pcfg, device="cpu")
    assert loaded.backend.db.device.type == "cpu" and loaded.backend.db.n_keyframes == 0
    assert loaded.occupancy_grid() is None
    system._async.close()
    assert psys.FrameResult._fields == jsys.FrameResult._fields


def test_yaml_config_matches_reference(tmp_path):
    path = "config/default.yaml"
    want, got = jconfig.system_config_from_yaml(path), pconfig.system_config_from_yaml(path)

    def flat(t):
        return {k: flat(v) if hasattr(v, "_asdict") else v for k, v in t._asdict().items()}

    assert flat(got) == flat(want)
    assert got.lifelong.optimize_window == 50 and got.async_backend is True
    # the shipped configuration constructs unchanged (it asks for the
    # worker-thread backend) and processes a frame
    system = MultiLidarSystem(got, device="cpu")
    assert system._async is not None and system._async.policy == "coalesce"
    rng = np.random.default_rng(0)
    xyz = (rng.normal(size=(2000, 3)) * [8, 8, 0.5]).astype(np.float32)
    res = system.process(PPB(torch.as_tensor(xyz), torch.ones(2000, dtype=torch.bool),
                             torch.zeros(2000, 1)), 0.0)
    system.flush()
    assert res.is_keyframe and system.backend.db.n_keyframes == 1
    system._async.close()
    doc = dict(keyframe_rot_deg=10.0, loop=dict(adjacent_window="3"), deskew=1)
    assert flat(pconfig.system_config_from_dict(doc)) == flat(jconfig.system_config_from_dict(doc))
    with pytest.raises(KeyError, match="unknown config key 'loop.adjacent'"):
        pconfig.system_config_from_dict(dict(loop=dict(adjacent=3)))
    with pytest.raises(TypeError, match="expected a mapping"):
        pconfig._merge(psys.SystemConfig(), [1])
    occ = dict(lifelong=dict(occupancy=dict(size=64, resolution="0.5"), optimize_window=7))
    assert flat(pconfig.system_config_from_dict(occ)) == flat(jconfig.system_config_from_dict(occ))
    assert pconfig.system_config_from_dict(occ).lifelong.occupancy.size == 64
    with pytest.raises(KeyError, match="unknown config key 'lifelong.occupancy.cells'"):
        pconfig.system_config_from_dict(dict(lifelong=dict(occupancy=dict(cells=64))))
    dup = tmp_path / "dup.yaml"
    dup.write_text("n_lidars: 1\nfeature:\n  rings: 16\nn_lidars: 2\n")
    for mod in (jconfig, pconfig):
        with pytest.raises(KeyError, match="duplicate config key 'n_lidars'"):
            mod.system_config_from_yaml(str(dup))


def test_stage_timer_matches_reference(tmp_path):
    samples = {"kf_insert": [0.004, 0.002, 0.009], "optimize_full": [0.25]}
    pt_, jt_ = StageTimer(), JStageTimer()
    for timer in (pt_, jt_):
        for label, xs in samples.items():
            for x in xs:
                timer.add(label, x)
    assert pt_.stats() == jt_.stats()
    assert pt_.report() == jt_.report()
    pt_.save_json(str(tmp_path / "p.json"))
    jt_.save_json(str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    pt_.save_csv(str(tmp_path / "p.csv"), "kf_insert")
    jt_.save_csv(str(tmp_path / "j.csv"), "kf_insert")
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    with pt_("stage", block_on=torch.zeros(1)):  # a CPU tensor: nothing to wait for
        pass
    with pt_("stage", block_on="cpu"):
        pass
    assert pt_.stats()["stage"]["n"] == 2
