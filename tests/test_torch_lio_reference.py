"""The port's IMU-aided frame (``MultiLidarSystem`` with ``use_imu=True``) held
frame by frame to the benchmark's plain reference of the step
(``benchmark/reference/eskf.py``: plain torch in float64, importing neither
JAX nor the program), on the CPU at a small size: a seeded circle and a
straight line of motion-blurred sweeps with the benchmark's 100 Hz IMU
windows (``benchmark/gen/``).

Each frame is redone from the system's own filter state before it: the
propagation over the window and its covariance, the failure reset (one
window made to trip it), the deskew of both clouds by the motion the
reference's own prediction gives, and the pose correction where the
frame's solve was accepted (where it was not, the filter is left as the
propagation made it). The tolerances are float32 (the port) against
float64 (the reference); each is tight enough that the reference fed its
inputs and state in bfloat16 breaks it, which one case per part checks.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.harness import LIO_DEFAULTS
from benchmark.reference import eskf as ref
from benchmark.reference import se3 as ref_se3
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch
from lmsf_slam_tpu_torch.lio import lio_tracker
from lmsf_slam_tpu_torch.system import MultiLidarSystem
from lmsf_slam_tpu_torch.system.config import system_config_from_dict
from tests import torch_threads  # noqa: F401

SEED = 2**31 + 207
N_FRAMES = 7
SENSOR = {"rings": 16, "width": 360, "max_range": 40.0}
IMU = {"rate_hz": 100, "gyro_noise": 1e-3, "acc_noise": 2e-2}
# as dense as the benchmark's tiny IMU cell: in a sparser world the first
# solves can land far enough off the prediction that the tracker refuses them
WORLD = {"extent": 30.0, "n_boxes": 40, "n_cylinders": 64}
MIXES = {
    # a quarter turn every 30 frames: attitude and velocity turn in the window
    "circle": {"course": "circle", "world": WORLD, "frames_per_lap": 120, "radius": 9.0,
               "z": 1.4, "imu": IMU, "sweep_motion": "moving"},
    "line": {"course": "line", "world": WORLD, "step_m": 0.47, "z": 1.4, "imu": IMU,
             "sweep_motion": "moving"},
}
SYSTEM = {"feature": {"rings": 16, "width": 360, "edges_per_sector": 3, "surfs_per_sector": 10},
          "tracker_window": 6, "registration": {"max_iters": 6, "max_corr_dist": 1.0},
          "use_imu": True}
TRIPPED = 4  # the frame whose window is made to trip the failure reset
CFG = LIO_DEFAULTS["eskf"]

# Tolerances, float32 port against float64 reference (the largest gaps read
# on both courses, and the least the bfloat16 control reads, in brackets):
# position, velocity and biases over a window of ten mid-point steps at
# positions under 30 m and speeds under 10 m/s, float32 keeping ~6e-8 of
# each (1.0e-6; bfloat16 3.7e-4, 4e-3 of each value)
STATE_ATOL = 2e-5
# the attitude, as the angle between the two quaternions, rad (3.1e-8;
# bfloat16 4.5e-5)
ANGLE_TOL = 1e-6
# the covariance, over its largest entry: float32 sums of 15-term products
# (8.1e-7; bfloat16 9.3e-4)
COV_RTOL = 1e-5
# the deskewed clouds, m, points up to 40 m out: the deskew's own rounding
# and the prediction's, turned over 40 m (1.5e-5; bfloat16 0.060, points at
# 20 m moved by up to 0.06 m)
CLOUD_ATOL = 1e-4


def _f64(x):
    return torch.as_tensor(x).detach().to(torch.float64)


def _low(x):
    """The bfloat16 control: a value stored in bfloat16, worked in float32
    (``torch.linalg.solve`` has no bfloat16 kernel)."""
    return torch.as_tensor(x).detach().to(torch.bfloat16).to(torch.float32)


def _state(st, cast=_f64):
    return {k: cast(getattr(st, k) if not isinstance(st, dict) else st[k]) for k in ref.FIELDS}


def _gaps(ours: dict, theirs) -> dict:
    """Largest gaps of a reference state to the port's: p, v, ba, bg (m or
    m/s), the attitude angle (rad) and the covariance over its largest
    entry."""
    t = _state(theirs)
    o = {k: v.to(torch.float64) for k, v in ours.items()}
    gaps = {k: float(torch.max(torch.abs(o[k] - t[k]))) for k in ("p", "v", "ba", "bg")}
    dq = ref_se3.so3_log(ref_se3.qmul(ref_se3.qconj(o["q"]), t["q"]))
    gaps["q"] = float(torch.linalg.vector_norm(dq))
    gaps["cov"] = float(torch.max(torch.abs(o["cov"] - t["cov"])) / torch.max(torch.abs(t["cov"])))
    return gaps


def _within(gaps: dict) -> bool:
    return (max(gaps[k] for k in ("p", "v", "ba", "bg")) <= STATE_ATOL
            and gaps["q"] <= ANGLE_TOL and gaps["cov"] <= COV_RTOL)


def _record(system, monkeypatch):
    """A list that gains, for each frame of ``system``'s LIO tracker, what
    the step saw and made: the filter before it, the IMU window, the
    tracker's pose before it, the propagation's result, the filter the
    registration started from (after the failure reset), each deskew's
    input and output, the registration's output and the filter after it."""
    lio = system._lio
    frames = []
    process, propagate = lio.process_scan, lio._propagate
    deskew, tracker_step = lio_tracker.deskew, lio_tracker.tracker_step

    def rec_process(edge, surf, timestamp, gyro=None, acc=None, imu_dts=None, **kw):
        frames.append({"before": lio.eskf, "prev_pose": lio.prev_pose, "deskew": [],
                       "window": None if gyro is None else (gyro, acc, imu_dts)})
        out = process(edge, surf, timestamp, gyro=gyro, acc=acc, imu_dts=imu_dts, **kw)
        frames[-1]["after"] = lio.eskf
        return out

    def rec_propagate(*a, **kw):
        frames[-1]["propagated"] = propagate(*a, **kw)
        return frames[-1]["propagated"]

    def rec_deskew(pb, times, motion):
        out = deskew(pb, times, motion)
        frames[-1]["deskew"].append((pb, times, out))
        return out

    def rec_step(*a, **kw):
        frames[-1]["selected"] = lio.eskf
        state, out = tracker_step(*a, **kw)
        frames[-1]["out"] = out
        return state, out

    lio.process_scan, lio._propagate = rec_process, rec_propagate
    monkeypatch.setattr(lio_tracker, "deskew", rec_deskew)
    monkeypatch.setattr(lio_tracker, "tracker_step", rec_step)
    return frames


def run_system(course, trip=False):
    """The recorded frames of the port's ``use_imu`` system over the first
    frames of ``course``, its velocity seeded from the course as a caller on
    a moving platform does; with ``trip`` frame ``TRIPPED``'s window carries
    400 m/s² more forward acceleration, which the failure gate catches."""
    tr = traffic.Traffic(MIXES[course], SENSOR, SEED, "cpu", N_FRAMES)
    system = MultiLidarSystem(system_config_from_dict(SYSTEM), device="cpu")
    system._lio.eskf = system._lio.eskf._replace(v=torch.as_tensor(tr.initial_velocity()))
    n = TRIPPED + 1 if trip else N_FRAMES
    with pytest.MonkeyPatch.context() as mp:
        frames = _record(system, mp)
        for k in range(n):
            (xyz, mask, attr), window = tr.frame(k)
            kw = {}
            if window is not None:
                gyro, acc, dts = window
                if trip and k == TRIPPED:
                    acc = acc + np.array([400.0, 0.0, 0.0], np.float32)
                kw = dict(gyro=gyro, acc=acc, imu_dts=dts)
            system.process(PointBatch(xyz, mask, attr), tr.stamp(k), **kw)
    return frames


@pytest.fixture(scope="module")
def runs():
    return {course: run_system(course) for course in MIXES}


def redo(frame, cast=_f64):
    """The reference's step from the frame's filter state before it: (the
    propagated state, failed, the state the registration starts from, the
    deskewed clouds by its own prediction, the corrected state where the
    frame's solve was accepted, else the state it started from)."""
    st = _state(frame["before"], cast)
    propagated, failed, clouds = None, False, []
    if frame["window"] is not None:
        gyro, acc, dts = (cast(x) for x in frame["window"])
        propagated = ref.propagate(st, gyro, acc, dts, CFG)
        st, failed = ref.reset_if_failed(propagated, LIO_DEFAULTS)
        motion = ref_se3.between(cast(frame["prev_pose"]), ref.pose_of(st))
        for pb, times, _ in frame["deskew"]:
            clouds.append(ref.deskew(cast(pb.xyz), pb.mask, cast(times), motion))
    selected = st
    out = frame["out"]
    if bool(out.solve_ok):
        st = ref.update_pose(st, cast(out.pose), LIO_DEFAULTS["reg_pos_std"],
                             LIO_DEFAULTS["reg_rot_std"])
    return propagated, failed, selected, clouds, st


def part_gaps(frames, part, cast=_f64):
    """Per frame with that part, the largest gaps of the reference to the
    port: states as :func:`_gaps`, clouds in metres."""
    out = []
    for frame in frames:
        propagated, failed, selected, clouds, corrected = redo(frame, cast)
        if part == "propagate" and propagated is not None:
            assert not failed
            out.append(_gaps(_state(frame["propagated"]), propagated))
            out.append(_gaps(_state(frame["selected"]), selected))
        elif part == "deskew" and clouds:
            assert len(clouds) == 2
            out.append({"cloud": max(float(torch.max(torch.abs(c - _f64(o.xyz))))
                                     for c, (_, _, o) in zip(clouds, frame["deskew"]))})
        elif part == "correct":
            out.append(_gaps(_state(frame["after"]), corrected))
    return out


def _cloud_within(gaps):
    return gaps["cloud"] <= CLOUD_ATOL


@pytest.mark.parametrize("part", ["propagate", "deskew", "correct"])
@pytest.mark.parametrize("course", sorted(MIXES))
def test_each_frame_is_the_references_from_the_systems_state(runs, course, part):
    frames = runs[course]
    assert len(frames) == N_FRAMES and frames[0]["window"] is None
    gaps = part_gaps(frames, part)
    # frame 0 has no window: no propagation and no deskew; every frame corrects
    assert len(gaps) == {"propagate": 2 * (N_FRAMES - 1), "deskew": N_FRAMES - 1,
                         "correct": N_FRAMES}[part]
    check = _cloud_within if part == "deskew" else _within
    assert all(check(g) for g in gaps), gaps
    if part == "correct":
        # most solves are accepted; a refused one leaves the filter as the
        # propagation made it, bit for bit
        ok = [bool(f["out"].solve_ok) for f in frames]
        assert sum(ok) >= N_FRAMES - 2, ok
        for f, accepted in zip(frames, ok):
            if not accepted:
                assert all(torch.equal(getattr(f["after"], k), getattr(f["selected"], k))
                           for k in ref.FIELDS)


@pytest.mark.parametrize("part", ["propagate", "deskew", "correct"])
def test_the_reference_in_bfloat16_breaks_the_tolerances(runs, part):
    """The same frames redone by the reference with its inputs and state
    stored in bfloat16: every frame breaks the part's tolerance."""
    gaps = part_gaps(runs["circle"], part, cast=_low)
    check = _cloud_within if part == "deskew" else _within
    assert gaps and not any(check(g) for g in gaps), gaps


def test_a_tripped_window_resets_the_filter_as_the_reference_does():
    """Frame ``TRIPPED``'s window, 400 m/s² too fast, trips the failure gate
    in the port and the reference alike: velocity and biases zeroed, the
    initial covariance restored, the propagated pose kept; the frames before
    it do not trip."""
    frames = run_system("circle", trip=True)
    for k, frame in enumerate(frames[1:], start=1):
        propagated, failed, selected, _, corrected = redo(frame)
        assert failed == (k == TRIPPED)
        assert _within(_gaps(_state(frame["propagated"]), propagated))
        assert _within(_gaps(_state(frame["selected"]), selected))
        assert _within(_gaps(_state(frame["after"]), corrected))
    tripped = frames[TRIPPED]["selected"]
    assert float(torch.linalg.vector_norm(frames[TRIPPED]["propagated"].v)) > 30.0
    assert not bool(torch.any(tripped.v)) and not bool(torch.any(tripped.ba))
    init = ref.init_cov(CFG, torch.zeros(3, dtype=torch.float64))
    torch.testing.assert_close(tripped.cov.double(), init, rtol=1e-6, atol=0)
    torch.testing.assert_close(tripped.p, frames[TRIPPED]["propagated"].p, rtol=0, atol=0)
