"""The port's front-end frame as a whole: ``build_featurize`` (preprocess →
organize → LOAM features), ``tracker_step`` and the frame's one read-back with
the keyframe gate, as ``MultiLidarSystem.process`` runs them, against the
reference composing the same public functions as its fused step
(``lmsf_slam_tpu/system/ml_system.py``, ``_build_fused_step``), on the CPU.

Small size: 16 rings × 360 columns, 192 edge and 768 surf features, a window
of 4 scans. Front end: features bit-identical each frame (the same float32
formulas, no reduction across points). Tracker: the reference evaluated in
float64, as in ``tests/test_torch_tracker.py``; pose within 1e-4 m and
1e-4 rad a frame, ``map_updated`` identical. Keyframe decisions identical.

The slice as a whole is ``MultiLidarSystem.process`` over the closed course
of ``tests/test_torch_lifelong.py``, in files of their own so that parallel
workers can take them apart: ``tests/test_torch_slice_looped.py`` (the sync
system, its exports and a reboot) and ``tests/test_torch_slice_lifelong.py``
(the lifelong deployment). The reference side is the reference's own
``MultiLidarSystem`` behind the port's tracker (``ReferenceSystem`` here):
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
from lmsf_slam_tpu_torch.tracker import tracker_init, tracker_step
from tests.test_torch_lifelong import LIFELONG, LOOP
from tests.test_torch_tracker import assert_frame, reference_step64, sim_course, widen_state
from tests import torch_threads  # noqa: F401

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
    tc = psys.tracker_config_for(pcfg)
    featurize = psys.build_featurize(pcfg, device="cpu")
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
        edge, surf, _ = featurize(xyz, mask, attr)
        state, out = tracker_step(state, edge, surf, t, tc)
        j_edge, j_surf = jax.tree.map(np.asarray, reference_front_end(xyz, mask, attr))
        for got, want in ((edge, j_edge), (surf, j_surf)):
            np.testing.assert_array_equal(got.mask.numpy(), want.mask)
            np.testing.assert_array_equal(got.xyz.numpy(), want.xyz)
        ref, want = reference_step64(ref, j_edge, j_surf, t, jtc)
        assert_frame(out, want, i)
        odom_pose, converged, num_matches = psys._read_back(out)
        is_keyframe = pgate.need_update(odom_pose, t)
        assert is_keyframe == jgate.need_update(np.asarray(want.pose, np.float32), t)
        assert num_matches == int(want.registration.num_matches)
        assert converged == bool(want.registration.converged)
        np.testing.assert_array_equal(odom_pose, out.pose.numpy())
        poses.append(odom_pose)
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


FRAME_SPANS = ("frame.featurize", "frame.track", "frame.read_back", "frame.handoff")


@pytest.mark.parametrize("method", ["feature_based", "sparse_point_plane_icp"])
def test_one_lidar_process_is_featurize_then_tracker_step(method):
    """With one LiDAR, ``MultiLidarSystem.process`` gives, frame by frame and
    bit for bit, the odometry of ``build_featurize`` and ``tracker_step``
    composed by hand on the same scans, and records the frame's four spans
    once a frame, inside its ``frame`` span."""
    _, pcfg = _configs()
    pcfg = pcfg._replace(registration_method=method)
    system = MultiLidarSystem(pcfg, device="cpu")
    tc = psys.tracker_config_for(pcfg)
    featurize = psys.build_featurize(pcfg, device="cpu")
    state = tracker_init(tc, device="cpu")
    _, scans = sim_course(N_FRAMES)
    for i, scan in enumerate(scans):
        t = 0.1 * i
        edge, surf, grid = featurize(*scan)
        state, out = tracker_step(state, edge, surf, t, tc,
                                  scan_grid=grid if tc.carve_map else None)
        res = system.process(_port_scan(scan), t)
        np.testing.assert_array_equal(res.odom_pose, psys._read_back(out)[0], err_msg=str(i))
    samples = system.timer.samples
    assert len(samples["frame"]) == N_FRAMES
    for label in FRAME_SPANS:
        assert len(samples[label]) == N_FRAMES, label
        for frame, span in zip(samples["frame"], samples[label]):
            # a span's end from its start and its duration in float seconds: 1 µs slack
            assert frame.start_ns <= span.start_ns, label
            assert (span.start_ns + round(span * 1e9)
                    <= frame.start_ns + round(frame * 1e9) + 1_000), label


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


def test_unported_system_paths_are_rejected(tmp_path):
    _, pcfg = _system_configs()
    # what raised before it was ported now runs: the ICP method (one frame
    # here; tests/test_torch_icp_system.py holds it to the reference), several LiDARs
    # (tests/test_torch_multilidar.py drives them), the IMU-aided front end
    # (tests/test_torch_lio_system.py), the worker-thread backend, save and
    # load (the database lands on the device that load names)
    f = pcfg.feature
    dual = MultiLidarSystem(pcfg._replace(n_lidars=2), device="cpu")
    assert dual.calib_status == 0 and dual.extrinsics == [None]
    assert (dual.tracker_config.surf_capacity, dual.backend.db.surf_capacity,
            dual._sub_config.surf_capacity) == (2 * f.surf_capacity, 2 * f.surf_capacity,
                                                f.surf_capacity)
    with pytest.raises(ValueError, match="extrinsics"):
        MultiLidarSystem(pcfg._replace(n_lidars=3, extrinsics=(np.eye(1),)), device="cpu")
    imu = MultiLidarSystem(pcfg._replace(use_imu=True), device="cpu")
    assert imu._lio is not None and imu._lio.config.tracker.pred_trust_k == 0.3
    system = MultiLidarSystem(pcfg._replace(async_backend=True), device="cpu")
    assert system._async is not None and system._pending_gnss is None
    path = str(tmp_path / "x.npz")
    system.save(path)
    loaded = MultiLidarSystem.load(path, pcfg, device="cpu")
    assert loaded.backend.db.device.type == "cpu" and loaded.backend.db.n_keyframes == 0
    assert loaded.occupancy_grid() is None
    system._async.close()
    assert psys.FrameResult._fields == jsys.FrameResult._fields
    icp = MultiLidarSystem(pcfg._replace(registration_method="sparse_point_plane_icp"),
                           device="cpu")
    _, scans = sim_course(1)
    res = icp.process(_port_scan(scans[0]), 0.0)
    assert np.isfinite(res.odom_pose).all() and np.isfinite(res.map_pose).all()
    assert res.is_keyframe and icp.backend.db.n_keyframes == 1


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
    with pt_("stage"):
        pass
    with pt_("stage"):
        pass
    assert pt_.stats()["stage"]["n"] == 2
