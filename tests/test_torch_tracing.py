"""Spans of the port's frame and worker, on the CPU.

``MultiLidarSystem.process`` records ``frame`` and, inside it,
``frame.featurize``, ``frame.track``, ``frame.read_back`` and
``frame.handoff`` on the backend's ``StageTimer``; the worker of
``AsyncBackend`` records ``worker.keyframe`` and ``worker.queue_wait`` there.
Each sample is its duration in seconds and carries ``start_ns`` (Unix ns, the
clock ``torch.profiler`` stamps its events with) and ``thread``. A few frames
of the simulator at 16 × 360.
"""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lmsf_slam_tpu_torch.backend.lifelong import LifelongConfig
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch
from lmsf_slam_tpu_torch.datasets import make_sim_world, make_trajectory, simulate_scan
from lmsf_slam_tpu_torch.system import FeatureParams, MultiLidarSystem, SystemConfig
from lmsf_slam_tpu_torch.utils.profiling import MAX_SAMPLES, StageTimer
from tests import torch_threads  # noqa: F401

STAGES = ("frame.featurize", "frame.track", "frame.read_back", "frame.handoff")
N_FRAMES = 6
SLACK_NS = 1_000  # a span's end from its start and its duration in float seconds


def scans(n, seed=0):
    rng = np.random.default_rng(seed)
    world = make_sim_world(rng, extent=18.0, n_boxes=8, n_cylinders=14)
    traj = make_trajectory(n, radius=4.0, loop=True, device="cpu")
    traj[:, 6] = 1.2
    return [simulate_scan(world, traj[i], rng, rings=16, width=360, max_range=40.0, device="cpu")
            for i in range(n)]


def config(**kw):
    return SystemConfig(
        feature=FeatureParams(rings=16, width=360, edges_per_sector=2, surfs_per_sector=8),
        tracker_window=4, keyframe_trans=0.3,
        lifelong=LifelongConfig(optimize_batch=5, optimize_window=8, graph_pad_min=64,
                                window_pad_min=16), **kw)


def end_ns(span):
    return span.start_ns + round(span * 1e9)


@pytest.fixture(scope="module")
def run():
    """N_FRAMES frames through the async backend, the last under a CPU
    ``torch.profiler``: (system, results, the last frame's profiler events)."""
    system = MultiLidarSystem(config(async_backend=True), device="cpu")
    frames = scans(N_FRAMES)
    results = [system.process(s, 0.1 * i) for i, s in enumerate(frames[:-1])]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results.append(system.process(frames[-1], 0.1 * (N_FRAMES - 1)))
    system.flush()
    events = [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()]
    yield system, results, events
    system._async.close()


def test_every_frame_records_its_spans_inside_the_frame(run):
    system, results, _ = run
    samples = system.timer.samples
    frames = list(samples["frame"])
    assert len(frames) == len(results) == N_FRAMES
    for label in STAGES:
        assert len(samples[label]) == N_FRAMES, label
    me = threading.get_ident()
    for i, frame in enumerate(frames):
        spans = [samples[label][i] for label in STAGES]
        assert all(s.thread == me for s in spans + [frame])
        # in order, each inside the frame
        starts = [s.start_ns for s in spans]
        assert starts == sorted(starts)
        assert frame.start_ns <= starts[0]
        assert all(end_ns(s) <= end_ns(frame) + SLACK_NS for s in spans)
        assert sum(spans) <= frame


def test_every_keyframe_records_the_worker_spans(run):
    system, results, _ = run
    n_kf = sum(r.is_keyframe for r in results)
    assert n_kf >= 2
    work = list(system.timer.samples["worker.keyframe"])
    waits = list(system.timer.samples["worker.queue_wait"])
    assert len(work) == len(waits) == n_kf
    frame_thread = system.timer.samples["frame"][0].thread
    assert all(s.thread != frame_thread for s in work + waits)
    assert len({s.thread for s in work + waits}) == 1
    for wait, kf in zip(waits, work):
        # the wait runs from the submit, inside a frame's hand-off, to the
        # worker's pick-up, just before the keyframe's span
        assert wait >= 0.0 and wait.start_ns <= kf.start_ns
        assert any(h.start_ns <= wait.start_ns <= end_ns(h) for h in system.timer.samples[
            "frame.handoff"])
        assert abs(end_ns(wait) - kf.start_ns) < 100_000_000
    # the backend's own stages nest inside the worker's span
    insert = system.timer.samples["kf_insert"]
    assert len(insert) == n_kf
    for s, kf in zip(insert, work):
        assert kf.start_ns <= s.start_ns and end_ns(s) <= end_ns(kf) + SLACK_NS


def test_spans_share_the_profilers_clock(run):
    system, _, events = run
    frame = system.timer.samples["frame"][-1]  # the profiled frame
    first = min(s for name, s in events if name.startswith("aten::"))
    assert 0 <= first - frame.start_ns < 1_000_000
    timer = StageTimer()
    x = torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer("span"):
            x.cumsum(0)
    op = next(e for e in prof.profiler.kineto_results.events() if e.name() == "aten::cumsum")
    assert 0 <= op.start_ns() - timer.samples["span"][0].start_ns < 1_000_000


@pytest.mark.parametrize("path", ["split", "lio"])
def test_every_path_of_process_records_the_frame_spans(path):
    """Two LiDARs (the hand-eye phase) and the IMU-aided frame, on the sync
    backend; one LiDAR without an IMU is ``run``'s."""
    kw = dict(n_lidars=2) if path == "split" else dict(use_imu=True)
    system = MultiLidarSystem(config(**kw), device="cpu")
    frames = scans(2)
    for i, s in enumerate(frames):
        system.process([s, s] if path == "split" else s, 0.1 * i)
    samples = system.timer.samples
    assert len(samples["frame"]) == 2
    for i, frame in enumerate(samples["frame"]):
        spans = [samples[label][i] for label in STAGES]
        assert frame.start_ns <= spans[0].start_ns
        assert all(end_ns(s) <= end_ns(frame) + SLACK_NS for s in spans)
    assert "worker.keyframe" not in samples  # no worker on the sync backend


def test_a_label_keeps_its_newest_samples():
    timer = StageTimer()
    for i in range(MAX_SAMPLES + 10):
        timer.add("stage", 1e-3 * (i % 7), start_ns=i)
    kept = list(timer.samples["stage"])
    assert len(kept) == MAX_SAMPLES
    assert [s.start_ns for s in kept] == list(range(10, MAX_SAMPLES + 10))
    want = [1e-3 * (i % 7) for i in range(10, MAX_SAMPLES + 10)]
    assert kept == want and sum(kept) == pytest.approx(sum(want))
    s = timer.stats()["stage"]
    assert s["n"] == MAX_SAMPLES and s["total_s"] == pytest.approx(sum(want))
    assert s["max_ms"] == pytest.approx(6.0)
    # a span measured elsewhere without a start is taken to have ended now
    before = time.time_ns()
    timer.add("late", 0.5)
    late = timer.samples["late"][0]
    assert late == 0.5 and before - 500_000_000 <= late.start_ns <= time.time_ns() - 500_000_000
    assert late.thread == threading.get_ident()
