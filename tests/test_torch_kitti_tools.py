"""The port's KITTI entry point and its tooling against the reference, on the
CPU: the KITTI reader, calibration and poses (``datasets/kitti.py``) on
``tests/test_kitti.py``'s fixture; the native bindings (``native/``) on
``tests/test_native.py``'s cases; ``rpe_stats`` and the KITTI trajectory
files (``evaluation/metrics.py``); ``make_world`` / ``scan_at``
(``datasets/synthetic.py``); the databus; ``render_map``; ``device_trace``;
``entry()``; and ``scripts/evaluate_torch.py --dataset sim`` on a few frames.

Tolerances: the readers and the bus exactly; poses from KITTI rows within
1e-6 (both round the same float64 matrices to float32 through the same
formulas); RPE within 1e-6 m (float32 SE(3) in both).
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.common.databus import DataBus as JDataBus
from lmsf_slam_tpu.datasets import kitti as jkitti
from lmsf_slam_tpu.datasets import synthetic as jsyn
from lmsf_slam_tpu.evaluation import metrics as jmetrics
from lmsf_slam_tpu_torch import native
from lmsf_slam_tpu_torch.common.databus import DataBus
from lmsf_slam_tpu_torch.common.pointcloud import ATTR_INTENSITY, ATTR_TIME
from lmsf_slam_tpu_torch.datasets import (
    SyntheticWorld, kitti, make_trajectory, make_world, scan_at)
from lmsf_slam_tpu_torch.evaluation import metrics
from tests import torch_threads  # noqa: F401
from tests.test_kitti import make_fixture

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# KITTI reader, calibration and poses
# ---------------------------------------------------------------------------


@pytest.fixture()
def fixture(tmp_path):
    scans, poses_cam = make_fixture(str(tmp_path))
    return str(tmp_path), scans, poses_cam


def test_velodyne_reader_matches_reference(fixture):
    root, scans, _ = fixture
    path = os.path.join(root, "sequences", "00", "velodyne", "000001.bin")
    want = jkitti.read_velodyne_bin(path, capacity=256)
    got = kitti.read_velodyne_bin(path, capacity=256, device="cpu")
    for k in ("xyz", "mask", "attr"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), k)
    assert int(got.count()) == 200
    t = got.attr[:200, ATTR_TIME].numpy()
    assert t.min() >= 0.0 and t.max() < 1.0 and t[0] == 0.0
    np.testing.assert_array_equal(got.attr[:200, ATTR_INTENSITY].numpy(), scans[1][:, 3])


def test_calib_and_poses_match_reference(fixture):
    root, _, _ = fixture
    calib = os.path.join(root, "sequences", "00", "calib.txt")
    poses = os.path.join(root, "poses", "00.txt")
    np.testing.assert_array_equal(kitti.read_calib(calib), jkitti.read_calib(calib))
    for c in (calib, None):
        want = np.asarray(jkitti.load_poses(poses, c))
        got = kitti.load_poses(poses, c)
        assert got.dtype == np.float32 and got.shape == want.shape == (4, 7)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_sequence_matches_reference(fixture):
    root, _, _ = fixture
    want = jkitti.KittiSequence(root, "00", capacity=256)
    got = kitti.KittiSequence(root, "00", capacity=256, device="cpu")
    assert len(got) == len(want) == 4
    for (tg, pg), (tw, pw) in zip(got, want):
        assert tg == tw and pg.xyz.device.type == "cpu"
        np.testing.assert_array_equal(pg.xyz.numpy(), np.asarray(pw.xyz))
        np.testing.assert_array_equal(pg.attr.numpy(), np.asarray(pw.attr))
    np.testing.assert_allclose(got.ground_truth(), np.asarray(want.ground_truth()), atol=1e-6)


# ---------------------------------------------------------------------------
# native bindings: tests/test_native.py's cases, built into build/native/
# ---------------------------------------------------------------------------


def test_native_library_builds_beside_the_kernels():
    assert native.native_available()
    path = native.bindings.library_path()
    assert path.exists() and path.parent == ROOT / "build" / "native"
    assert path.parent != ROOT / "native"


def test_read_f32_matches_numpy(tmp_path):
    data = np.random.default_rng(0).normal(size=(1000, 4)).astype(np.float32)
    path = str(tmp_path / "scan.bin")
    data.tofile(path)
    np.testing.assert_array_equal(native.read_f32(path), data.reshape(-1))
    np.testing.assert_array_equal(native.read_f32(path, max_floats=12), data.reshape(-1)[:12])
    with pytest.raises(IOError):
        native.read_f32(str(tmp_path / "missing.bin"))


def test_pcd_roundtrip(tmp_path):
    xyz = np.random.default_rng(1).normal(size=(257, 3)).astype(np.float32)
    path = str(tmp_path / "kf.pcd")
    native.write_pcd(path, xyz)
    np.testing.assert_array_equal(native.read_pcd(path), xyz)
    with open(path, "rb") as f:
        assert f.read(64).startswith(b"# .PCD v0.7")


def test_ring_buffer_order_and_bounds():
    ring = native.NativeRing(slot_floats=16, n_slots=4)
    for i in range(4):
        assert ring.push(np.full(8, float(i), np.float32))
    assert not ring.push(np.zeros(8, np.float32))  # full
    assert len(ring) == 4
    for i in range(4):
        out = ring.pop()
        assert out.shape == (8,) and out[0] == float(i)
    assert ring.pop() is None  # empty
    with pytest.raises(ValueError):
        ring.push(np.zeros(32, np.float32))  # oversize payload
    ring.close()


def test_prefetcher_streams_files_in_order(tmp_path):
    paths = []
    for i in range(10):
        p = str(tmp_path / f"{i:06d}.bin")
        np.full(100 + i, float(i), np.float32).tofile(p)
        paths.append(p)
    got = list(native.ScanPrefetcher(paths, slot_floats=256, n_slots=3))
    assert [a.shape for a in got] == [(100 + i,) for i in range(10)]
    assert all((a == float(i)).all() for i, a in enumerate(got))


# ---------------------------------------------------------------------------
# metrics: RPE and the KITTI trajectory files
# ---------------------------------------------------------------------------


def _noisy_pair(n=40, seed=2):
    gt = make_trajectory(n, radius=7.0, loop=False, device="cpu").numpy()
    rng = np.random.default_rng(seed)
    est = gt.copy()
    est[:, 4:] += rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
    q = est[:, :4] + rng.normal(scale=0.01, size=(n, 4)).astype(np.float32)
    est[:, :4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return est, gt


@pytest.mark.parametrize("delta", [1, 10])
def test_rpe_matches_reference(delta):
    est, gt = _noisy_pair()
    want = jmetrics.rpe_stats(est, gt, delta=delta)
    got = metrics.rpe_stats(est, gt, delta=delta)
    assert got.n == want.n == 40 - delta
    np.testing.assert_allclose(tuple(got)[:6], tuple(want)[:6], rtol=1e-5, atol=1e-6)
    assert metrics.rpe_stats(gt, gt, delta=1).rmse < 1e-5  # tests/test_evaluation.py


def test_kitti_trajectory_files_match_reference(tmp_path):
    est, _ = _noisy_pair()
    mine, theirs = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    metrics.save_kitti_trajectory(est, mine)
    jmetrics.save_kitti_trajectory(est, theirs)
    np.testing.assert_allclose(np.loadtxt(mine), np.loadtxt(theirs), atol=1e-7, rtol=0)
    back = metrics.load_kitti_trajectory(mine)
    np.testing.assert_allclose(back, np.asarray(jmetrics.load_kitti_trajectory(mine)), atol=1e-6)
    # tests/test_evaluation.py::test_kitti_roundtrip
    np.testing.assert_allclose(back[:, 4:], est[:, 4:], atol=1e-5)
    np.testing.assert_allclose(np.abs(back[:, 0]), np.abs(est[:, 0]), atol=1e-5)


# ---------------------------------------------------------------------------
# synthetic worlds, databus, render, device trace, entry
# ---------------------------------------------------------------------------


def test_make_world_has_the_reference_structure():
    want = jsyn.make_world(jax.random.PRNGKey(0), extent=20.0, n_pillars=12, pts_per_pillar=16,
                           n_ground=800, n_wall=400)
    got = make_world(np.random.default_rng(0), extent=20.0, n_pillars=12, pts_per_pillar=16,
                     n_ground=800, n_wall=400, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.asarray(w).shape) and g.dtype == torch.float32
    e, s = got.edge_pts.numpy(), got.surf_pts.numpy()
    ew = np.asarray(want.edge_pts)
    np.testing.assert_allclose(e[:16, 2], ew[:16, 2], atol=1e-6)  # the pillars' z samples
    assert np.all(e[:16, :2] == e[0, :2])  # one pillar = one vertical line
    assert np.all(s[:800, 2] == 0.0) and np.all(np.abs(s[:, :2]) <= 20.0)
    walls = s[800:]
    assert np.all(np.isclose(np.abs(walls[:, :2]), 20.0).any(axis=1))


def test_scan_at_samples_the_reference_visible_set():
    """Without noise and with room for every visible point, both packages'
    scans are the visible set of the same world, in any order."""
    world = jsyn.make_world(jax.random.PRNGKey(1), extent=15.0, n_pillars=8, pts_per_pillar=8,
                            n_ground=600, n_wall=200)
    pworld = SyntheticWorld(*(torch.as_tensor(np.asarray(a)) for a in world))
    pose = np.asarray(make_trajectory(5, radius=3.0, loop=False, device="cpu")[2])
    want = jsyn.scan_at(world, jnp.asarray(pose), jax.random.PRNGKey(3), n_edge=64, n_surf=800,
                        max_range=12.0, noise=0.0)
    got = scan_at(pworld, torch.as_tensor(pose), np.random.default_rng(3), n_edge=64,
                  n_surf=800, max_range=12.0, noise=0.0)
    for g, w in zip(got, want):
        gm, wm = g.mask.numpy(), np.asarray(w.mask)
        assert gm.sum() == wm.sum() and 0 < gm.sum() < gm.shape[0]
        gp = g.xyz.numpy()[gm]
        wp = np.asarray(w.xyz)[wm]
        np.testing.assert_allclose(gp[np.lexsort(gp.T)], wp[np.lexsort(wp.T)], atol=1e-5)


def test_databus_pubsub():
    """tests/test_config_bus.py::test_databus_pubsub on both buses."""
    for bus in (DataBus(), JDataBus()):
        bus.register("odom", dict, capacity=3)
        for i in range(5):
            bus.publish("odom", {"i": i})
        assert bus.size("odom") == 3 and bus.latest("odom")["i"] == 4
        assert [g["i"] for g in bus.read_all("odom", consumer="viz")] == [2, 3, 4]
        assert bus.read("odom", consumer="viz") is None
        assert bus.read("odom", consumer="log")["i"] == 2
        with pytest.raises(TypeError):
            bus.publish("odom", [1, 2])
        with pytest.raises(ValueError):
            bus.register("odom", dict)


def test_device_trace_writes_a_trace(tmp_path):
    from lmsf_slam_tpu_torch.utils import device_trace

    with device_trace(None) as prof:
        assert prof is None
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
        # a second thread's ops (the backend's worker) are traced too
        worker = threading.Thread(target=lambda: torch.ones(64).cumprod(0))
        worker.start()
        worker.join(10.0)
    assert not worker.is_alive()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    tid = {e["name"]: e.get("tid") for e in trace["traceEvents"]}
    assert "aten::cumsum" in tid and "aten::cumprod" in tid
    assert tid["aten::cumprod"] != tid["aten::cumsum"]


def test_entry_runs_the_flagship_step():
    from lmsf_slam_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    state, pose, converged = fn(*args)
    assert tuple(pose.shape) == (7,) and torch.isfinite(pose).all()
    assert args[1].xyz.shape == (256, 3) and args[2].xyz.shape == (512, 3)


# ---------------------------------------------------------------------------
# scripts/evaluate_torch.py and render_map
# ---------------------------------------------------------------------------


def test_evaluate_torch_sim_writes_the_reference_outputs(tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "eval"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = str(torch.get_num_threads())  # tests/torch_threads.py's
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "evaluate_torch.py"), "--dataset", "sim",
         "--frames", "4", "--sync", "--device", "cpu", "--out", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == json.loads((out / "result.json").read_text())
    # scripts/evaluate.py's keys for a sync sim run, and the device
    assert {"dataset", "frames", "fps", "frame_ms_p50", "frame_ms_p99", "backend", "keyframes",
            "mode", "solver_runs", "loop_edges", "backend_stage_ms", "mode_counts",
            "ate"} <= set(result)
    assert result["frames"] == 4 and result["device"] == "cpu" and result["rendered"]
    for name in ("est_path.txt", "ground_truth.txt", "backend_history.csv", "map.png"):
        assert (out / name).stat().st_size > 0, name
    assert np.loadtxt(out / "est_path.txt").shape == (4, 12)
    assert (out / "map.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    rows = (out / "backend_history.csv").read_text().splitlines()
    assert rows[0] == "mode,keyframe_id,score,overlap,loop_closed" and len(rows) > 1
