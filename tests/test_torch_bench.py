"""The port's benchmark scripts against ``bench.py``, on the CPU.

``bench_torch.py`` keeps bench.py's constants, its pose-graph recipe
(``build_posegraph``), its frame (organize → LOAM features →
``tracker_step``) and its scan-to-scan registration pair; its printed result
keeps bench.py's schema. Here each piece is held against the reference on
the same numpy inputs at a small width (16 × 360, 2 sectors), the tracker
and the registration against the reference evaluated in float64 (the
standing note of ``tests/test_torch_registration.py``: the float32 reference
is ill-conditioned on ring scans). The front-end profile and the map render
CLI run on the CPU.
"""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch as B
from lmsf_slam_tpu.common import se3 as jse3
from lmsf_slam_tpu.ops import features as jf
from lmsf_slam_tpu.ops import registration as jr
from lmsf_slam_tpu.tracker import tracker as jt
from lmsf_slam_tpu_torch.backend import KeyframeDatabase
from lmsf_slam_tpu_torch.common import se3, se3np
from lmsf_slam_tpu_torch.ops import registration as pr
from lmsf_slam_tpu_torch.tracker import tracker_init, tracker_step
from tests.test_torch_registration import assert_result, reference_f64, to_port
from tests.test_torch_slice import _reference_tracker_config
from tests.test_torch_tracker import assert_frame, reference_step64, widen_state
from tests import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(rings=16, width=360, sectors=2, edges_ps=20, surfs_ps=40)
N_FRAMES = 2


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, f"{ROOT}/scripts/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_and_schema_match_bench():
    names = ("BASELINE_SCAN_MAP_MS", "BASELINE_SCAN_SCAN_MS", "RINGS", "WIDTH", "SECTORS",
             "EDGES_PS", "SURFS_PS", "N_WARM", "N_FRAMES")
    assert {n: getattr(B, n) for n in names} == {n: getattr(bench, n) for n in names}
    out = B.summary(80.0, {"vlp16": 10.0, "hdl64": 5.0}, (90.0, 1e7, 500.0, 0.5, 60, 40.0, 0.4),
                    20.0, 21.0)
    # bench.py main()'s printed keys
    assert list(out) == ["metric", "value", "unit", "vs_baseline", "extras"]
    assert out["metric"] == "frontend_fps_per_chip"
    assert list(out["extras"]) == ["registration_fps_vlp16", "registration_fps_hdl64",
                                   "posegraph_1905v_ms", "posegraph_1905v_schur_ms",
                                   "e2e_system_fps"]
    assert list(out["extras"]["posegraph_1905v_ms"]) == ["value", "unit", "chi2", "solve_ate_m",
                                                         "gn_iters_used"]
    assert list(out["extras"]["e2e_system_fps"]) == ["value", "unit", "vs_baseline", "sync_fps"]
    assert out["vs_baseline"] == round(80.0 / (1000.0 / 105.9), 2)
    json.dumps(out)


def _reference_graph(V, x64):
    """bench.py's recipe (``bench_posegraph``, up to the solve) through the
    reference's se3, in float32 as bench.py runs it, or evaluated in float64."""
    with jax.enable_x64(x64):
        f = jnp.float64 if x64 else jnp.float32
        compose, between, exp = (jax.jit(g) for g in (jse3.pose_compose, jse3.pose_between,
                                                      jse3.se3_exp))
        rng = np.random.default_rng(0)
        # bench.py's float32 inputs, widened exactly in float64
        step = exp(jnp.asarray(np.float32([0, 0, 0.04, 1.2, 0, 0.08]), f))
        gt = [jse3.pose_identity().astype(f)]
        for _ in range(V - 1):
            gt.append(compose(gt[-1], step))
        eij, ez = [], []
        for i in range(V - 1):
            z = between(gt[i], gt[i + 1])
            pert = np.float32(np.concatenate([rng.normal(0, 0.01, 3), rng.normal(0, 0.05, 3)]))
            pert = jnp.asarray(pert, f)
            eij.append((i, i + 1))
            ez.append(compose(z, exp(pert)))
        for _ in range(96):
            i = int(rng.integers(0, V - 200))
            j = int(rng.integers(i + 100, V))
            eij.append((i, j))
            ez.append(between(gt[i], gt[j]))
        init = [gt[0]]
        for e in range(V - 1):
            init.append(compose(init[-1], ez[e]))
        return (np.asarray(jnp.stack(gt)), np.asarray(eij, np.int32), np.asarray(jnp.stack(ez)),
                np.asarray(jnp.stack(init)))


def _pose_diff(a, b):
    """|a − b| per component with the quaternion's sign aligned (q ≡ −q)."""
    a, b = np.asarray(a, np.float64).copy(), np.asarray(b, np.float64)
    a[:, :4] *= np.sign(np.sum(a[:, :4] * b[:, :4], axis=1))[:, None]
    return np.abs(a - b)


def test_build_posegraph_is_bench_recipe():
    """Edges and masks equal. Measurements against the recipe evaluated in
    float64 (bench.py's float32 inputs widened exactly): quaternions within
    1e-6 (measured 9e-8), translations within 2e-5 m (measured 1.4e-5 m: both
    recipes store the ground truth in float32, whose rounding at up to 152 m
    of climb is 7.6e-6 m a coordinate, so 1e-6 m cannot hold there); the
    float32 recipe as bench.py runs it lies 2.7e-5 from it on the odometry
    edges and 2.5e-3 on the loop edges, which span its float32 ground-truth
    chain's 2.7e-3 m drift. The integrated initial guess, which both packages
    integrate in float32 steps, against bench.py's float32 chain: within
    1e-3 m over the first 500 vertices (measured 4.5e-4 m) and within 4e-3 m
    over all 1905 (measured 2.8e-3 m at the end, where either chain lies
    0.12 m from the float64 integration of the same measurements)."""
    V = B.POSEGRAPH_VERTICES
    gt, plain, padded = B.build_posegraph()
    E = V - 1 + 96
    _, eij, ez32, init32 = _reference_graph(V, x64=False)
    gt64, eij64, ez64, _ = _reference_graph(V, x64=True)
    np.testing.assert_array_equal(plain["edges_ij"], eij)
    np.testing.assert_array_equal(eij64, eij)
    assert plain["edges_ij"].dtype == np.int32 and plain["edges_z"].dtype == np.float32
    np.testing.assert_array_equal(plain["vmask"], np.ones(V, bool))
    np.testing.assert_array_equal(plain["emask"], np.ones(E, bool))
    np.testing.assert_array_equal(plain["edges_robust"], np.arange(E) >= V - 1)  # loop edges
    np.testing.assert_array_equal(plain["edges_sqrtw"], np.tile([100.0] * 3 + [20.0] * 3, (E, 1)))
    dz = _pose_diff(plain["edges_z"], ez64)
    assert dz[:, :4].max() < 1e-6 and dz[:, 4:].max() < 2e-5
    assert _pose_diff(gt, gt64).max() < 1e-5
    d32 = _pose_diff(plain["edges_z"], ez32)
    assert d32[: V - 1].max() < 1e-4 and d32[V - 1:].max() < 5e-3
    di = _pose_diff(plain["poses"], init32)
    assert di[:, :4].max() < 1e-5
    assert di[:500, 4:].max() < 1e-3
    assert di[:, 4:].max() < 4e-3
    # bench.py's padding: 2048 vertices and edge slots, identities, vertex 0
    # and the tail fixed
    P = B.POSEGRAPH_PADDED
    np.testing.assert_array_equal(padded["poses"][:V], plain["poses"])
    np.testing.assert_array_equal(padded["poses"][V:], np.tile([1, 0, 0, 0, 0, 0, 0], (P - V, 1)))
    for key in ("edges_ij", "edges_z", "edges_sqrtw", "edges_robust"):
        np.testing.assert_array_equal(padded[key][:E], plain[key])
    np.testing.assert_array_equal(padded["edges_ij"][E:], 0)
    np.testing.assert_array_equal(padded["edges_z"][E:], np.tile([1, 0, 0, 0, 0, 0, 0], (P - E, 1)))
    np.testing.assert_array_equal(padded["emask"], np.arange(P) < E)
    np.testing.assert_array_equal(padded["fixed"], (np.arange(P) == 0) | (np.arange(P) >= V))


def _course_scans(n, seeds=None):
    world, traj = B.make_course()
    seeds = range(n) if seeds is None else seeds
    return traj, [B.make_scan(world, traj[i], s, SMALL["rings"], SMALL["width"], device="cpu")
                  for i, s in enumerate(seeds)]


@jax.jit
def _reference_features(xyz, mask, attr):
    """bench.py's step up to the tracker: organize, then LOAM features."""
    from lmsf_slam_tpu.common.pointcloud import PointBatch

    grid = jf.organize_scan(PointBatch(xyz, mask, attr), rings=SMALL["rings"],
                            width=SMALL["width"])
    feats = jf.extract_loam_features(grid, sectors=SMALL["sectors"],
                                     edges_per_sector=SMALL["edges_ps"],
                                     surfs_per_sector=SMALL["surfs_ps"])
    return feats.edge, feats.surf


def _features(scan):
    edge, surf = _reference_features(*(getattr(scan, k).numpy() for k in ("xyz", "mask", "attr")))
    return jax.tree.map(np.asarray, edge), jax.tree.map(np.asarray, surf)


def _assert_same_features(got, want):
    for g, w in zip((got.edge, got.surf), want):
        np.testing.assert_array_equal(g.mask.numpy(), w.mask)
        np.testing.assert_array_equal(g.xyz.numpy(), w.xyz)


def test_frontend_step_matches_bench():
    """bench_torch's frame against bench.py's (organize and features in
    float32, bit for bit; the reference's ``tracker_step`` in float64 with
    bench.py's tracker configuration): pose within 1e-4 m and 1e-4 rad a
    frame, the map update and the registration's counters equal."""
    _, scans = _course_scans(N_FRAMES)
    small = {k: SMALL[k] for k in ("rings", "sectors", "edges_ps", "surfs_ps")}
    config = B.tracker_config(**small)
    assert (config.window, config.registration.max_iters) == (20, 10)
    assert (config.edge_capacity, config.surf_capacity) == (640, 1280)
    jconfig = _reference_tracker_config(config)
    step = B.make_step(config, **SMALL)
    state = tracker_init(config, device="cpu")
    ref = widen_state(jt.tracker_init(jconfig))
    for i, scan in enumerate(scans):
        t = torch.tensor(0.1 * i, dtype=torch.float32)
        want_feats = _features(scan)
        got_feats = B.front_end(scan, **SMALL)
        _assert_same_features(got_feats, want_feats)
        ref, want = reference_step64(ref, *want_feats, 0.1 * i, jconfig)
        # the step itself, and the tracker on its features (for the flags)
        before = state
        state, pose = step(state, scan, t)
        _, out = tracker_step(before, got_feats.edge, got_feats.surf, t, config)
        torch.testing.assert_close(pose, out.pose, rtol=0, atol=0)
        assert_frame(out, want, i)


def test_registration_pair_matches_bench():
    """bench_torch's scan-to-scan pair against bench.py's ``reg``: features
    bit for bit, ``register_edge_surf`` from identity with 10 GN iterations
    against the reference's in float64 (pose 1e-5, counters exact)."""
    traj, (a, b) = _course_scans(2, seeds=B.REG_SEEDS)
    got = B.registration_pair(a, b, SMALL["rings"], SMALL["width"], SMALL["edges_ps"],
                              SMALL["surfs_ps"], sectors=SMALL["sectors"])
    fa, fb = _features(a), _features(b)
    _assert_same_features(B.front_end(a, **SMALL), fa)
    want = reference_f64(jr.register_edge_surf, fb[0], fb[1], fa[0], fa[1],
                         np.asarray(jse3.pose_identity()),
                         params=jr.RegistrationParams(max_iters=10))
    res = pr.register_edge_surf(to_port(fb[0]), to_port(fb[1]), to_port(fa[0]), to_port(fa[1]),
                                se3.pose_identity(device="cpu"), pr.RegistrationParams(max_iters=10))
    torch.testing.assert_close(got, res.pose, rtol=0, atol=0)
    assert_result(res, want)
    # the pair moves by the course's first step
    true = se3np.pose_between(traj[0], traj[1])
    assert np.linalg.norm(got.numpy()[4:] - true[4:]) < 0.05


def test_render_map_cli_writes_png(tmp_path):
    """The map render CLI on a database the port saved (the reference's city
    checkpoint loaded through the port and saved again)."""
    pytest.importorskip("matplotlib")
    db = KeyframeDatabase.load(f"{ROOT}/eval_out_city/city_db.npz", device="cpu")
    path = tmp_path / "port_db.npz"
    db.save(str(path))
    png = tmp_path / "map.png"
    assert _load_script("render_map_torch").main(
        [str(path), "--out", str(png), "--max-points", "20000", "--device", "cpu"]) == 0
    assert png.stat().st_size > 10_000
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_profile_frontend_prints_every_stage(monkeypatch, capsys):
    """The front-end profile on the CPU at a small width: every stage in the
    table, then the JSON line."""
    mod = _load_script("profile_frontend_torch")
    for key, name in (("rings", "RINGS"), ("width", "WIDTH"), ("sectors", "SECTORS"),
                      ("edges_ps", "EDGES_PS"), ("surfs_ps", "SURFS_PS")):
        monkeypatch.setattr(mod, name, SMALL[key])
    assert mod.main(["--frames", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    for stage in mod.STAGES + ("total_frame",):
        assert any(line.startswith(stage) and line.split()[1] == "2" for line in out), stage
    last = json.loads(out[-1])
    assert last["frames"] == 2 and last["device"] == "cpu" and last["mean_frame_ms"] > 0
