"""The port's lifelong backend (``lmsf_slam_tpu_torch.backend.lifelong``)
against the reference (``lmsf_slam_tpu/backend/lifelong.py``), on the CPU.

Both backends are fed the same keyframes: feature clouds made by the
reference's front end from 40 ray-cast scans (16 × 360) around a closed
circle of 4 m radius, and the ground-truth poses with a drift added to every
step as odometry. Gates are scaled down to that course (a loop may close
after 12 keyframes). The reference runs as it ships, in float32; its
verification and localization registrations carry the float32 noise named in
``tests/test_torch_registration.py``, so: every decision (mode, keyframe id,
loop closed, loop edge ids, solver runs) is compared exactly; map poses while
mapping within 1e-4 m (both compose the same odometry); the optimized
database within 5e-3 m and localization poses within 5e-2 m (measured 2e-3
and 3e-2, against the float32 reference's own 0.1 m from its float64
evaluation); scores within 20 % + 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lmsf_slam_tpu.backend import keyframe_db as jdb
from lmsf_slam_tpu.backend import lifelong as jll
from lmsf_slam_tpu.backend import loop_closure as jlc
from lmsf_slam_tpu.backend import pose_graph as jpg
from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
from lmsf_slam_tpu.ops import features as jf
from lmsf_slam_tpu.ops import preprocess as jp
from lmsf_slam_tpu_torch.backend import keyframe_db as pdb
from lmsf_slam_tpu_torch.backend import lifelong as pll
from lmsf_slam_tpu_torch.backend import loop_closure as plc
from lmsf_slam_tpu_torch.backend import pose_graph as ppg
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch as PPB
from lmsf_slam_tpu_torch.datasets import make_sim_world, make_trajectory, simulate_scan
from lmsf_slam_tpu_torch.interop import (
    KEYFRAME_DB_EDGE_FIELDS,
    KEYFRAME_DB_FIELDS,
    backend_state_from_numpy,
    keyframe_db_from_numpy,
)
from tests.test_torch_registration import to_port

W = 360
N = 40
RADIUS = 4.0
FEATURES = dict(sectors=6, edges_per_sector=2, surfs_per_sector=8)
EC, SCAP = 16 * 6 * 2, 16 * 6 * 8
LOOP = dict(min_frame_interval=12, exclude_recent=6, detect_spacing=1, search_radius=4.0,
            adjacent_window=2, refine_score_thresh=0.3, reloc_score_thresh=0.3)
LIFELONG = dict(optimize_batch=5, optimize_window=8, graph_pad_min=64, window_pad_min=16)
DB = dict(edge_capacity=EC, surf_capacity=SCAP, initial_keyframes=8, mirror_min_cap=64)


def loop_course(n=N, radius=RADIUS, seed=0):
    """World, ground-truth poses of a closed circle (sensor at 1.2 m) and
    the scans as numpy (xyz, mask, attr)."""
    rng = np.random.default_rng(seed)
    world = make_sim_world(rng, extent=18.0, n_boxes=8, n_cylinders=14)
    traj = make_trajectory(n, radius=radius, loop=True, device="cpu").numpy().astype(np.float64)
    traj[:, 6] = 1.2
    scans = []
    for i in range(n):
        s = simulate_scan(world, traj[i].astype(np.float32), rng, rings=16, width=W,
                          max_range=40.0, device="cpu")
        scans.append((s.xyz.numpy(), s.mask.numpy(), s.attr.numpy()))
    return traj, scans


@jax.jit
def reference_features(xyz, mask, attr):
    grid = jf.organize_scan(jp.preprocess(JPB(xyz, mask, attr)), rings=16, width=W)
    feats = jf.extract_loam_features(grid, **FEATURES)
    return feats.edge, feats.surf


def drifted_odometry(traj):
    drift = se3np.se3_exp(np.array([0, 0, 0.002, 0.01, 0.004, 0.0]))
    odom = [traj[0]]
    for i in range(1, len(traj)):
        inc = se3np.pose_between(traj[i - 1], traj[i])
        odom.append(se3np.pose_compose(odom[-1], se3np.pose_compose(inc, drift)))
    return np.asarray(odom, np.float32)


def make_backends(lifelong=None, loop=None, jdb_=None, pdb_=None):
    lifelong, loop = {**LIFELONG, **(lifelong or {})}, {**LOOP, **(loop or {})}
    jl = {k: (jpg.PoseGraphParams(**v) if k == "pose_graph" else v) for k, v in lifelong.items()}
    pl = {k: (ppg.PoseGraphParams(**v) if k == "pose_graph" else v) for k, v in lifelong.items()}
    jb = jll.LifelongBackend(db=jdb_ if jdb_ is not None else jdb.KeyframeDatabase(**DB),
                             config=jll.LifelongConfig(**jl), loop_config=jlc.LoopConfig(**loop))
    pb = pll.LifelongBackend(
        db=pdb_ if pdb_ is not None else pdb.KeyframeDatabase(**DB, device="cpu"),
        config=pll.LifelongConfig(**pl), loop_config=plc.LoopConfig(**loop))
    return jb, pb


def carry_database(j):
    fields = {k: np.asarray(getattr(j, k)) for k in KEYFRAME_DB_FIELDS + KEYFRAME_DB_EDGE_FIELDS}
    fields.update(n_keyframes=j.n_keyframes, n_edges=j.n_edges, edge_capacity=j.edge_capacity,
                  surf_capacity=j.surf_capacity)
    return keyframe_db_from_numpy(fields, device="cpu", mirror_min_cap=64)


def assert_same_decisions(jh, ph):
    assert len(jh) == len(ph)
    for i, (a, b) in enumerate(zip(jh, ph)):
        assert (a.mode.name, a.keyframe_id, bool(a.loop_closed)) == (
            b.mode.name, b.keyframe_id, bool(b.loop_closed)), i
        assert np.isnan(a.score) == np.isnan(b.score), i
        if not np.isnan(a.score):
            assert b.score == pytest.approx(a.score, rel=0.2, abs=1e-3), i
            assert b.overlap == pytest.approx(a.overlap, abs=0.02), i


@pytest.fixture(scope="module")
def mapped():
    """The mapping run in both packages: (reference backend, port
    backend, ground truth, odometry, feature clouds as numpy)."""
    traj, scans = loop_course()
    odom = drifted_odometry(traj)
    feats = [jax.tree.map(np.asarray, reference_features(*map(jnp.asarray, s))) for s in scans]
    jb, pb = make_backends()
    for i, (e, s) in enumerate(feats):
        jb.add_keyframe(0.1 * i, e, s, odom[i])
        pb.add_keyframe(0.1 * i, to_port(e), to_port(s), odom[i])
    return jb, pb, traj, odom, feats


def test_mapping_run_takes_the_reference_decisions(mapped):
    jb, pb, traj, _, _ = mapped
    assert_same_decisions(jb.history, pb.history)
    modes = [h.mode for h in pb.history]
    closed = [h.loop_closed for h in pb.history]
    assert sum(closed) >= 1
    first = closed.index(True)
    assert all(m is pll.WorkMode.MAPPING for m in modes[:first])
    assert modes[first] is pll.WorkMode.LOCALIZATION  # MAPPING → LOCALIZATION on the loop
    assert pb.solver_runs == jb.solver_runs
    assert pb.solver_runs["full_replicated"] >= 1 and pb.solver_runs["windowed"] >= 1
    assert pb.mode.name == jb.mode.name and pb._pending == jb._pending
    for a, b in zip(jb.history, pb.history):
        tol = 1e-4 if b.mode is pll.WorkMode.MAPPING else 5e-2
        np.testing.assert_allclose(b.map_pose, a.map_pose, atol=tol)
        np.testing.assert_allclose(b.odom2map, a.odom2map, atol=tol)
    # the map-frame poses beat the drifted odometry at the end of the loop
    err_map = np.linalg.norm(pb.history[-1].map_pose[4:] - traj[-1, 4:])
    assert err_map < 0.15


def test_databases_agree_after_the_run(mapped):
    jb, pb, _, _, _ = mapped
    j, p = jb.db, pb.db
    assert (p.n_keyframes, p.n_edges) == (j.n_keyframes, j.n_edges)
    n, e = j.n_keyframes, j.n_edges
    np.testing.assert_array_equal(p.eij[:e], j.eij[:e])  # the same loop edge ids
    np.testing.assert_array_equal(p.eloop[:e], j.eloop[:e])
    assert p.eloop[:e].sum() >= 1
    np.testing.assert_array_equal(p.edge_xyz[:n], j.edge_xyz[:n])
    np.testing.assert_array_equal(p.sc[:n], j.sc[:n])
    np.testing.assert_allclose(p.map_poses[:n], j.map_poses[:n], atol=5e-3)
    np.testing.assert_allclose(p.ez[:e], j.ez[:e], atol=5e-3)
    np.testing.assert_allclose(p.esqrtw[:e], j.esqrtw[:e], rtol=0.05)
    assert set(pb.timer.stats()) == set(jb.timer.stats())


def test_reboot_relocalizes_to_the_same_keyframe(mapped):
    """The reference's database carried across; both packages boot in
    RELOCALIZATION, match the same keyframe for a scan from the middle of
    the course in a fresh odometry frame, and localize on from there."""
    jb, _, traj, _, feats = mapped
    j2, p2 = make_backends(jdb_=jb.db, pdb_=carry_database(jb.db))
    assert p2.mode is pll.WorkMode.RELOCALIZATION and j2.mode is jll.WorkMode.RELOCALIZATION
    start = 15
    e, s = feats[start]
    rj = j2.loop_detector.relocalize(j2.db, e, s)
    rp = p2.loop_detector.relocalize(p2.db, to_port(e), to_port(s))
    assert rp is not None and rj is not None
    assert rp.matched_id == rj.matched_id
    assert abs(rp.matched_id - start) <= 2
    np.testing.assert_allclose(rp.pose, rj.pose, atol=5e-2)
    for i in range(start, start + 4):
        odom = np.asarray(se3np.pose_between(traj[start], traj[i]), np.float32)
        e, s = feats[i]
        a = j2.add_keyframe(100.0 + i, e, s, odom)
        b = p2.add_keyframe(100.0 + i, to_port(e), to_port(s), odom)
        np.testing.assert_allclose(b.map_pose, a.map_pose, atol=5e-2)
        # the map frame is the first run's, whose odometry began at the
        # ground-truth pose: the world frame
        assert np.linalg.norm(b.map_pose[4:] - traj[i, 4:]) < 0.3
    assert_same_decisions(j2.history, p2.history)
    assert p2.history[0].mode is pll.WorkMode.LOCALIZATION


def test_backend_state_carried_across(mapped):
    jb, pb, _, _, _ = mapped
    fresh = pll.LifelongBackend(db=carry_database(jb.db))
    assert fresh.mode is pll.WorkMode.RELOCALIZATION
    backend_state_from_numpy(fresh, dict(mode=jb.mode, odom2map=jb.odom2map,
                                         last_stamp=jb.last_stamp, _pending=jb._pending))
    assert fresh.mode.name == jb.mode.name == "LOCALIZATION"
    np.testing.assert_array_equal(fresh.odom2map, np.asarray(jb.odom2map, np.float32))
    assert (fresh.last_stamp, fresh._pending) == (jb.last_stamp, jb._pending)
    for mode in ("MAPPING", 0):
        backend_state_from_numpy(fresh, dict(mode=mode, odom2map=jb.odom2map, last_stamp=0.0,
                                             _pending=0))
    assert fresh.mode is pll.WorkMode.RELOCALIZATION
    with pytest.raises(KeyError, match="odom2map"):
        backend_state_from_numpy(fresh, dict(mode="MAPPING", last_stamp=0.0, _pending=0))


def test_localization_loss_triggers_relocalization(mapped):
    jb, _, _, _, feats = mapped
    j2, p2 = make_backends(jdb_=jb.db, pdb_=carry_database(jb.db))
    e, s = feats[5]
    far = np.array([1.0, 0, 0, 0, 500.0, 500.0, 0.0], np.float32)
    outs = []
    for backend, mode, edge, surf in (
        (j2, jll.WorkMode.LOCALIZATION, JPB(e.xyz + 300.0, e.mask), JPB(s.xyz + 300.0, s.mask)),
        (p2, pll.WorkMode.LOCALIZATION, PPB(to_port(e).xyz + 300.0, to_port(e).mask),
         PPB(to_port(s).xyz + 300.0, to_port(s).mask)),
    ):
        backend.mode = mode
        outs.append(backend.add_keyframe(2000.0, edge, surf, far))
    assert outs[0].mode.name == outs[1].mode.name == "RELOCALIZATION"
    assert outs[1].score == outs[0].score == 1e9 and outs[1].keyframe_id == -1


def test_timestamp_disorder_is_dropped(mapped):
    jb, pb, _, odom, feats = mapped
    n = pb.db.n_keyframes
    e, s = feats[0]
    a = jb.add_keyframe(-1.0, e, s, odom[3])
    b = pb.add_keyframe(-1.0, to_port(e), to_port(s), odom[3])
    assert a.keyframe_id == b.keyframe_id == -1 and pb.db.n_keyframes == n
    assert b.mode.name == a.mode.name and np.isnan(b.score)
    np.testing.assert_allclose(b.map_pose, a.map_pose, atol=5e-2)
    assert len(pb.history) == len(jb.history)  # a dropped keyframe leaves no history entry


@pytest.mark.parametrize("case", ["gnss", "plane", "gnss+plane+window"])
def test_optimize_with_priors_matches_reference(mapped, case):
    """A drifted open chain anchored by GNSS fixes on every third keyframe
    and/or a floor-plane factor on every second, through ``optimize`` (full)
    and ``_optimize_window``."""
    _, _, traj, odom, feats = mapped
    n = 14
    cfg = dict(optimize_batch=10**9, gnss_std=0.05, optimize_window=0,
               pose_graph=dict(gn_iters=20, kernel="none"))
    if "plane" in case:
        cfg.update(plane_constraint_every=2, plane_z=1.0)  # the course runs at 1.2 m
    if "window" in case:
        cfg.update(optimize_window=6)
    jb, pb = make_backends(lifelong=cfg, loop=dict(min_frame_interval=10**9))
    for i in range(n):
        gnss = traj[i, 4:].astype(np.float32) if "gnss" in case and i % 3 == 0 else None
        e, s = feats[i]
        jb.add_keyframe(0.1 * i, e, s, odom[i], gnss_pos=gnss)
        pb.add_keyframe(0.1 * i, to_port(e), to_port(s), odom[i], gnss_pos=gnss)
    before = pb.db.map_poses[:n].copy()
    full = "window" not in case
    sj, sp = jb.optimize(full=full), pb.optimize(full=full)
    assert pb.solver_runs == jb.solver_runs
    assert pb.solver_runs["full_replicated" if full else "windowed"] == 1
    assert int(sp.iterations) == int(sj.iterations)
    np.testing.assert_allclose(float(sp.chi2_final), float(sj.chi2_final), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(pb.db.map_poses[:n], jb.db.map_poses[:n], atol=1e-3)
    assert np.abs(pb.db.map_poses[:n] - before).max() > 1e-3
    if full and "gnss" in case:
        assert np.linalg.norm(pb.db.map_poses[n - 1, 4:] - traj[n - 1, 4:]) < 0.1
    if not full:
        np.testing.assert_array_equal(pb.db.map_poses[: n - 6], before[: n - 6])


def test_optimize_needs_an_edge_and_force_global_optimize_is_full(mapped):
    _, _, _, odom, feats = mapped
    _, pb = make_backends()
    assert pb.optimize() is None
    for i in range(3):
        pb.add_keyframe(0.1 * i, to_port(feats[i][0]), to_port(feats[i][1]), odom[i])
    assert pb.force_global_optimize() is not None
    assert pb.solver_runs == {"full_schur": 0, "full_replicated": 1, "windowed": 0}


def test_unported_branches_raise(mapped, tmp_path):
    """Nothing of the backend raises any more. The hooks that raised before
    this package had them now run: the occupancy grid, carving (only with a
    range image), ``save`` and ``load``, and the submap Schur solve of a full
    solve past ``schur_min_vertices`` (item 15), whose poses are the
    reference backend's (a 3-vertex graph: to 1e-5)."""
    _, _, _, odom, feats = mapped
    e, s = to_port(feats[0][0]), to_port(feats[0][1])

    def backend(**kw):
        return pll.LifelongBackend(db=pdb.KeyframeDatabase(**DB, device="cpu"),
                                   config=pll.LifelongConfig(**{**LIFELONG, **kw}),
                                   loop_config=plc.LoopConfig(**LOOP))

    from lmsf_slam_tpu_torch.mapping import OccupancyConfig

    b = backend(occupancy=OccupancyConfig(size=64, resolution=0.5))
    assert b.occupancy_grid().shape == (64, 64) and not b.occupancy_grid().any()
    b.add_keyframe(0.0, e, s, odom[0])
    assert b.occupancy_grid().any()
    b = backend(dynamic_carve_knn=3)
    b.add_keyframe(0.0, e, s, odom[0])  # no range image handed over: nothing to carve with
    assert not b.db._dirty_rows
    schur = dict(schur_submaps=4, schur_min_vertices=2)
    b = backend(**schur)
    ref = jll.LifelongBackend(db=jdb.KeyframeDatabase(**DB),
                              config=jll.LifelongConfig(**{**LIFELONG, **schur}),
                              loop_config=jlc.LoopConfig(**LOOP))
    for i in range(3):
        b.add_keyframe(0.1 * i, e, s, odom[i])
        ref.add_keyframe(0.1 * i, *feats[0], odom[i])
    for full in (False, True):  # the Schur solve serves full solves only
        b.optimize(full=full)
        ref.optimize(full=full)
    assert b.solver_runs == ref.solver_runs == {"full_schur": 1, "full_replicated": 1,
                                                "windowed": 0}
    np.testing.assert_allclose(b.db.map_poses[:3], ref.db.map_poses[:3], atol=1e-5)
    b.save(str(tmp_path / "x.npz"))
    loaded = pll.LifelongBackend.load(str(tmp_path / "x.npz"), device="cpu")
    assert loaded.db.n_keyframes == 3 and loaded.mode is pll.WorkMode.RELOCALIZATION
    assert [s_["kind"] for s_ in b.solve_log] == ["full_replicated", "full_schur"]
    assert all(s_["iterations"] >= 1 and s_["vertices"] == 3 for s_ in b.solve_log)


def test_unsupported_point_gate_raises_on_map_update(mapped):
    """A localized scan inside the map-update window (score ≤ gate, overlap
    inside its bounds) stores a keyframe and switches to MAPPING. With the
    unsupported-point gate configured (it raised before it was ported; the
    name is kept) the stored keyframe leaves out the scan points without map
    support, the same points as in the reference."""
    jb, _, traj, _, feats = mapped
    cfg = dict(map_update_score=1.0, map_update_overlap_lo=0.0, map_update_overlap_hi=1.01)
    e, s = feats[20]
    odom = traj[20].astype(np.float32)  # odom2map is the identity after the boot
    _, p2 = make_backends(lifelong=cfg, pdb_=carry_database(jb.db))
    p2.mode = pll.WorkMode.LOCALIZATION
    n = p2.db.n_keyframes
    out = p2.add_keyframe(50.0, to_port(e), to_port(s), odom)
    assert out.mode is pll.WorkMode.MAPPING and out.keyframe_id == n
    assert p2.db.n_edges == jb.db.n_edges + 1 and p2._pending == 1
    # a phantom object in the scan, 3 m up in free space: no map supports it
    ghost = np.array(e.xyz)
    free = np.nonzero(~np.asarray(e.mask))[0][:8]
    ghost[free] = np.array([1.0, 0.5, 3.0], np.float32) + 0.05 * np.arange(8)[:, None]
    gmask = np.array(e.mask)
    gmask[free] = True
    eg = JPB(jnp.asarray(ghost), jnp.asarray(gmask))
    gated = {**cfg, "dynamic_gate_unsupported": True}
    j3, p3 = make_backends(lifelong=gated, jdb_=carry_jax_database(jb.db),
                           pdb_=carry_database(jb.db))
    j3.mode, p3.mode = jll.WorkMode.LOCALIZATION, pll.WorkMode.LOCALIZATION
    a = j3.add_keyframe(50.0, eg, s, odom)
    b = p3.add_keyframe(50.0, to_port(eg), to_port(s), odom)
    assert (a.mode.name, a.keyframe_id) == (b.mode.name, b.keyframe_id) == ("MAPPING", n)
    stored_j, stored_p = j3.db.edge_mask[n], p3.db.edge_mask[n]
    assert not stored_p[free].any() and gmask[free].all()  # the phantom stayed out
    # the float32 reference's localization pose differs by up to 5e-2 m, so a
    # point at the 0.5 m support radius may fall on either side
    assert (stored_p != stored_j).sum() <= 0.02 * gmask.sum()
    assert (p3.db.surf_mask[n] != j3.db.surf_mask[n]).sum() <= 0.02 * np.asarray(s.mask).sum()
    assert stored_p.sum() < p2.db.edge_mask[n].sum() + 8


def test_solve_log_matches_the_reference_solves_after_a_loop_closure():
    """Every solve of a run that goes on mapping after its loop closed, held
    against the statistics the reference's solver returned for the same
    solve (its ``optimize_pose_graph`` is wrapped for the run, the package is
    untouched). With the map-update window open a localized scan is stored
    and the backend returns to MAPPING, so loop edges keep coming and every
    later solve is a full one over a graph with robust edges. The two graphs
    differ by the loop edges' measurements (5e-3, see the module docstring),
    so: the same solves in the same order over the same vertices; GN
    iterations equal or one apart (the exit test ``max|dx| < converged_dx``
    sits on those differences), and both well under the cap of ``gn_iters``,
    which shows the exit flag ends the loop in both; chi2 after the solve
    within 15 % (measured up to 10 %)."""
    n = 52
    traj, scans = loop_course()
    feats = [jax.tree.map(np.asarray, reference_features(*map(jnp.asarray, s))) for s in scans]
    odom = drifted_odometry(np.concatenate([traj, traj])[:n])
    jb, pb = make_backends(lifelong=dict(map_update_score=1.0, map_update_overlap_lo=0.0,
                                         map_update_overlap_hi=1.01))
    ref, solver = [], jll.optimize_pose_graph

    def recording(*args, **kwargs):
        out = solver(*args, **kwargs)
        ref.append(out[1])
        return out

    jll.optimize_pose_graph = recording
    try:
        for i in range(n):
            e, s = feats[i % N]
            jb.add_keyframe(0.1 * i, e, s, odom[i])
            pb.add_keyframe(0.1 * i, to_port(e), to_port(s), odom[i])
    finally:
        jll.optimize_pose_graph = solver
    assert_same_decisions(jb.history, pb.history)
    assert pb.solver_runs == jb.solver_runs and len(pb.solve_log) == len(ref)
    first = [h.loop_closed for h in pb.history].index(True)
    after = [s for s in pb.solve_log if s["keyframes"] > first]
    assert len(after) >= 5 and all(s["kind"] == "full_replicated" for s in after)
    cap = pb.config.pose_graph.gn_iters
    for want, got in zip(ref, pb.solve_log):
        assert abs(got["iterations"] - int(want.iterations)) <= 1, got
        assert got["iterations"] < cap and int(want.iterations) < cap, got
        assert got["chi2_final"] == pytest.approx(float(want.chi2_final), rel=0.15, abs=1e-6), got


def carry_jax_database(j):
    """A copy of a reference database (a run on it must not alter the
    fixture's)."""
    c = jdb.KeyframeDatabase(**{**DB, "initial_keyframes": max(j.n_keyframes, 1)})
    n, e = j.n_keyframes, j.n_edges
    for name in KEYFRAME_DB_FIELDS:
        getattr(c, name)[:n] = getattr(j, name)[:n]
    c._ensure_edge_capacity(max(e, 1))
    for name in KEYFRAME_DB_EDGE_FIELDS:
        getattr(c, name)[:e] = getattr(j, name)[:e]
    c.n_keyframes, c.n_edges = n, e
    return c


def test_configs_match_reference():
    want, got = jll.LifelongConfig()._asdict(), pll.LifelongConfig()._asdict()
    assert want.keys() == got.keys()
    for k in want:
        w, g = want[k], got[k]
        assert (g._asdict() == w._asdict()) if hasattr(w, "_asdict") else (g == w), k
    assert [m.name for m in pll.WorkMode] == [m.name for m in jll.WorkMode]
    assert [m.value for m in pll.WorkMode] == [m.value for m in jll.WorkMode]
    assert pll.BackendOutput._fields == jll.BackendOutput._fields
