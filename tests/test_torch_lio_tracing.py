"""The IMU-aided step's spans on the system's timer, on the CPU: every frame
with an IMU window records one each of ``lio.propagate``, ``lio.deskew``,
``lio.register`` and ``lio.correct`` inside its ``frame.track``, on the
frame's thread, with its start on the trace's clock; frame 0, which has no
window, records the last two alone; together they cover all but the edges
of ``frame.track``. The spans change nothing the step computes. The fused
one-LiDAR frame and the several-LiDAR frame record no ``lio.*`` span."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import contextlib

import pytest
import torch

from benchmark import traffic
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch
from lmsf_slam_tpu_torch.system import MultiLidarSystem
from lmsf_slam_tpu_torch.system.config import system_config_from_dict
from tests import torch_threads  # noqa: F401
from tests.test_torch_lio_reference import MIXES, SENSOR, SEED, SYSTEM

LIO = ("lio.propagate", "lio.deskew", "lio.register", "lio.correct")
N_FRAMES = 4


def run(system_dict, course="circle", frames=N_FRAMES, scans=1, timed=True):
    """The system ``system_dict`` states over the first frames of
    ``course`` (each scan given ``scans`` times, one a LiDAR), its filter's
    velocity seeded from the course where it has one; ``timed`` False takes
    the LIO step's timer away. Returns (system, results)."""
    tr = traffic.Traffic(MIXES[course], SENSOR, SEED, "cpu", frames)
    system = MultiLidarSystem(system_config_from_dict(system_dict), device="cpu")
    if system._lio is not None:
        system._lio.eskf = system._lio.eskf._replace(v=torch.as_tensor(tr.initial_velocity()))
        if not timed:
            system._lio._span = lambda label: contextlib.nullcontext()
    results = []
    for k in range(frames):
        (xyz, mask, attr), window = tr.frame(k)
        scan = PointBatch(xyz, mask, attr)
        kw = {} if window is None or system._lio is None else dict(
            zip(("gyro", "acc", "imu_dts"), window))
        results.append(system.process(scan if scans == 1 else [scan] * scans, tr.stamp(k), **kw))
    return system, results


def interval(span):
    return span.start_ns, span.start_ns + round(span * 1e9)


@pytest.mark.parametrize("course", sorted(MIXES))
def test_each_imu_aided_frame_records_its_stages_inside_frame_track(course):
    system, _ = run(SYSTEM, course)
    samples = system.timer.samples
    tracks = list(samples["frame.track"])
    assert len(tracks) == N_FRAMES
    for label in LIO:
        want = N_FRAMES - 1 if label in ("lio.propagate", "lio.deskew") else N_FRAMES
        assert len(samples[label]) == want, label
        for span in samples[label]:
            assert isinstance(span.start_ns, int) and span.thread == tracks[0].thread
    for k, track in enumerate(tracks):
        t0, t1 = interval(track)
        inside = {label: [s for s in samples[label] if t0 <= s.start_ns and interval(s)[1] <= t1]
                  for label in LIO}
        # frame 0 has no IMU window: no propagation, no deskew
        want = {label: int(k > 0 or label in ("lio.register", "lio.correct")) for label in LIO}
        assert {label: len(v) for label, v in inside.items()} == want, k
        # in the step's order, one after the other
        starts = [v[0].start_ns for v in inside.values() if v]
        assert starts == sorted(starts)
    lio = sum(sum(samples[label]) for label in LIO)
    assert lio >= 0.9 * sum(tracks)


def test_the_spans_change_nothing_the_step_computes():
    timed, a = run(SYSTEM)
    untimed, b = run(SYSTEM, timed=False)
    assert not any(label.startswith("lio.") for label in untimed.timer.samples)
    for ra, rb in zip(a, b):
        assert (ra.odom_pose == rb.odom_pose).all()
    for k in ("p", "v", "q", "ba", "bg", "cov"):
        assert torch.equal(getattr(timed._lio.eskf, k), getattr(untimed._lio.eskf, k))


@pytest.mark.parametrize("path", ["fused", "two_lidars"])
def test_the_paths_without_an_imu_record_no_lio_span(path):
    system_dict = dict(SYSTEM, use_imu=False)
    scans = 1
    if path == "two_lidars":
        system_dict["n_lidars"] = 2
        system_dict["extrinsics"] = [[1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]]
        scans = 2
    system, results = run(system_dict, frames=3, scans=scans)
    assert (system._fused_step is not None) == (path == "fused")
    labels = set(system.timer.samples)
    assert {"frame", "frame.featurize", "frame.track"} <= labels
    assert not any(label.startswith("lio.") for label in labels), labels
    assert len(results) == 3
