"""The IMU-aided frame through the harness at a tiny size on the CPU: a cell
whose mix carries a 100 Hz IMU window and motion-blurred sweeps, added from
files alone; the faults of the IMU-aided step the check has to catch; the
control; the frozen IMU stream and blurred sweep against the port's
generators; the plain filter against the port's; and the committed mixes'
scans against their values before these keys existed."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import hashlib
import json
import time

import numpy as np
import pytest
import torch

from benchmark import harness, traffic
from benchmark.gen import imu as gen_imu
from benchmark.reference import eskf as ref_eskf
from benchmark.reference import se3 as ref_se3

from test_harness_run import LIMITS, TINY_MIX, make_root

IMU = {"rate_hz": 100, "gyro_noise": 1e-3, "acc_noise": 2e-2}
# about three times the tiny cell's objects and more features a scan: in the
# tiny cell's sparse world the first frames' solves can land half a metre off
# the prediction, which the IMU-aided tracker's prediction-trust gate refuses,
# leaving the ring off the insertion rule the reference follows
DENSE = {"world": {"extent": 30.0, "n_boxes": 40, "n_cylinders": 64}}
DENSE_FEATURES = {"edges_per_sector": 3, "surfs_per_sector": 10}
# a quarter turn every 30 frames: the filter's attitude and velocity turn
# with the window, which a constant-velocity step cannot follow
TINY_TURN = dict(TINY_MIX, course="circle", frames_per_lap=120, radius=9.0)
# the tiny cell's filter readings (CPU, seed 2**31 + 91): sound 1.7e-5 /
# 6.1e-6 / 4.6e-7 (circle) and 1.6e-6 / 5.9e-7 / 7.0e-7 (line), the control
# 0.108 / 0.055 / 2.5e-3; each limit has more room above the sound reading
# than below the control's
IMU_LIMITS = dict(LIMITS, filter_gap_m=1e-3, filter_bias_gap_sd=1e-3, filter_cov_gap=1e-4)
FILTER_NUMBERS = ("filter_gap_m", "filter_bias_gap_sd", "filter_cov_gap")


def make_imu_root(tmp_path, course="line"):
    """A checkout whose one cell is the tiny cell with ``use_imu`` and a mix
    with ``imu`` and ``sweep_motion: "moving"``, all as files."""
    root = make_root(tmp_path, limits=IMU_LIMITS)
    base = root / "bench"
    config = json.loads((base / "configs" / "tiny.json").read_text())
    config["system"]["use_imu"] = True
    config["system"]["feature"].update(DENSE_FEATURES)
    (base / "configs" / "tiny.json").write_text(json.dumps(config))
    mix = dict(TINY_TURN if course == "circle" else TINY_MIX, **DENSE, imu=IMU,
               sweep_motion="moving")
    (base / "traffic" / "tinyline.json").write_text(json.dumps(mix))
    return root


def run_imu(root, capsys, control=False):
    rc = harness.run(["--workload", "tiny.tinyline", "--seed", str(2**31 + 91), "--seconds",
                      "3", "--trace", "0"], time.perf_counter(), device="cpu", root=root,
                     control=control)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.fixture(scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("course", ["line", "circle"])
def test_an_imu_cell_from_files_alone_is_correct(course, tmp_path, capsys, torch_threads):
    res, err = run_imu(make_imu_root(tmp_path, course), capsys)
    assert res["correct"] is True, err[-2000:]
    assert set(res["check"]) == set(IMU_LIMITS)
    assert res["check"]["filter_gap_m"]["value"] < 1e-4
    assert "filter steps held" in err


def _constant_velocity(self, gyro, acc, dts, wheel_speeds=None):
    """The filter carried by its own velocity over the window, its attitude
    held: the window's readings ignored."""
    st = self.eskf
    return st._replace(p=st.p + st.v * float(np.sum(dts)))


def _update_keeping(*fields):
    """The filter's pose correction with ``fields`` left as they were: an
    injection or a covariance update dropped."""
    from lmsf_slam_tpu_torch.lio import lio_tracker

    update = lio_tracker.eskf_update_pose

    def kept(st, *a, **kw):
        return update(st, *a, **kw)._replace(**{k: getattr(st, k) for k in fields})
    return kept


def _covariance_scaled_between_frames(monkeypatch):
    """The filter's covariance scaled by 1.01 after each frame, outside the
    LIO step: each redone step starts from the scaled state and reads sound,
    so only the link between the steps shows it."""
    from lmsf_slam_tpu_torch.system.ml_system import MultiLidarSystem

    process = MultiLidarSystem.process

    def scaled(self, *a, **kw):
        out = process(self, *a, **kw)
        self._lio.eskf = self._lio.eskf._replace(cov=self._lio.eskf.cov * 1.01)
        return out
    monkeypatch.setattr(MultiLidarSystem, "process", scaled)


# each fault and the numbers of which at least one has to fail
FAULTS = {"constant_velocity": ("frame_gap_m", "filter_gap_m"),
          "deskew_dropped": ("frame_gap_m", "filter_gap_m"),
          "correction_dropped": ("frame_gap_m", "filter_gap_m"),
          "attitude_injection_dropped": ("filter_gap_m",),
          "bias_injection_dropped": ("filter_bias_gap_sd",),
          "covariance_update_skipped": ("filter_cov_gap",),
          "covariance_scaled_between_frames": ("filter_cov_gap",)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_of_the_imu_aided_step_read_not_correct(fault, tmp_path, capsys, monkeypatch,
                                                       torch_threads):
    from lmsf_slam_tpu_torch.lio import lio_tracker

    if fault == "constant_velocity":
        monkeypatch.setattr(lio_tracker.LioTracker, "_propagate", _constant_velocity)
    elif fault == "deskew_dropped":
        monkeypatch.setattr(lio_tracker, "deskew", lambda pb, t, motion: pb)
    elif fault == "correction_dropped":
        monkeypatch.setattr(lio_tracker, "eskf_update_pose", lambda st, *a, **kw: st)
    elif fault == "attitude_injection_dropped":
        monkeypatch.setattr(lio_tracker, "eskf_update_pose", _update_keeping("q"))
    elif fault == "bias_injection_dropped":
        monkeypatch.setattr(lio_tracker, "eskf_update_pose", _update_keeping("ba", "bg"))
    elif fault == "covariance_update_skipped":
        monkeypatch.setattr(lio_tracker, "eskf_update_pose", _update_keeping("cov"))
    else:
        _covariance_scaled_between_frames(monkeypatch)
    res, _ = run_imu(make_imu_root(tmp_path, "circle"), capsys)
    assert res["correct"] is False
    check = res["check"]
    failed = {k for k, v in check.items() if v["value"] is None or v["value"] > v["limit"]}
    assert failed & set(FAULTS[fault]), check


def test_the_control_fails_the_imu_limits(tmp_path, capsys, torch_threads):
    res, _ = run_imu(make_imu_root(tmp_path, "circle"), capsys, control=True)
    assert res["correct"] is True
    ctl = res["control"]
    assert any(ctl[k] > v["limit"] for k, v in res["check"].items())
    for name in FILTER_NUMBERS:
        assert ctl[name] > res["check"][name]["limit"], (name, ctl[name])


# ----------------------------------------------------------------------------


def _state64(p=None, v=None, q=None):
    st = {"p": torch.zeros(3, dtype=torch.float64), "v": torch.zeros(3, dtype=torch.float64),
          "q": torch.tensor([1.0, 0, 0, 0], dtype=torch.float64),
          "ba": torch.zeros(3, dtype=torch.float64), "bg": torch.zeros(3, dtype=torch.float64)}
    for k, x in (("p", p), ("v", v), ("q", q)):
        if x is not None:
            st[k] = torch.as_tensor(x, dtype=torch.float64)
    st["cov"] = ref_eskf.init_cov(harness.LIO_DEFAULTS["eskf"], st["p"])
    return st


def test_a_noise_free_window_reproduces_the_course():
    """Integrated from the course's pose and velocity at frame k − 1, the
    noise-free window of frame k lands on the course's rotation at frame k
    within 1e-6 rad, and on its position within 1 mm on straights and arcs.
    The window's model is a constant acceleration between the central-
    difference velocities at k − 1 and k, so its displacement is their
    trapezoid, which it matches to 1 mm (each sample is rotated by the yaw
    at its step's middle where the mid-point integrator rotates it by the
    attitude at the step's ends, which turns a corner's 30 m/s² by up to
    0.2°); where the course's speed
    steps between 0.9 m a frame (straights) and 0.55 (corners), or its turn
    begins or ends, the central differences average the two sides and the
    trapezoid falls short of the chord by up to a quarter of the speed step
    and more where a turn begins there too (under 0.1 m): that is the port's
    generator, not the filter."""
    poses = traffic.city.make_city_course()[:400].astype(np.float64)
    v, yaw = gen_imu.course_rates(poses)
    cfg = harness.LIO_DEFAULTS["eskf"]
    chord = np.linalg.norm(np.diff(poses[:, 4:], axis=0), axis=1)
    turns = np.diff(yaw)
    for k in range(1, 399):
        gyro, acc, dts = gen_imu.imu_window(v, yaw, k, np.random.default_rng(0), gyro_noise=0.0,
                                            acc_noise=0.0)
        st = _state64(p=poses[k - 1, 4:], v=v[k - 1], q=poses[k - 1, :4])
        st = ref_eskf.propagate(st, *(torch.as_tensor(x, dtype=torch.float64)
                                      for x in (gyro, acc, dts)), cfg)
        got = ref_eskf.pose_of(st)
        want = torch.as_tensor(poses[k])
        turn = ref_se3.so3_log(ref_se3.qmul(ref_se3.qconj(got[:4]), want[:4]))
        assert float(torch.linalg.vector_norm(turn)) < 1e-6, k
        trapezoid = poses[k - 1, 4:] + 0.05 * (v[k - 1] + v[k])
        np.testing.assert_allclose(st["p"].numpy(), trapezoid, rtol=0, atol=1e-3)
        near = slice(max(k - 2, 0), min(k + 1, 399))  # the chords the velocities k-1, k span
        steady = np.ptp(chord[near]) < 1e-3 and np.ptp(turns[near]) < 1e-4
        gap = float(ref_se3.gap_m(got, want))
        assert gap < (1e-3 if steady else 0.1), (k, gap)


def test_the_imu_stream_is_the_ports_without_noise():
    from lmsf_slam_tpu_torch.datasets import make_city_course, make_city_imu

    course = make_city_course()[:60]
    theirs = make_city_imu(course, gyro_noise=0.0, acc_noise=0.0)
    v, yaw = gen_imu.course_rates(course)
    for k in (1, 17, 59):
        ours = gen_imu.imu_window(v, yaw, k, np.random.default_rng(1), gyro_noise=0.0,
                                  acc_noise=0.0)
        for a, b in zip(ours, theirs[k]):
            np.testing.assert_array_equal(a, b)


def test_the_blurred_sweep_is_the_ports():
    """The column poses are the port's within 2e-5 (m, and quaternion
    units): the port works them out in float32, whose (1 − cos θ)/θ² loses
    ~4e-5 of itself at this frame's 0.05 rad (measured: 1.03e-5 m at 9 m
    from the origin). Cast from the port's column poses, the sweep is the
    port's. From its own column poses every return lies within 1 mm of the
    port's: a ray that meets the ground at a grazing angle turns that pose
    gap into range by the inverse sine of the angle (measured: 2.6e-4 m at
    most, 53 of 4320 coordinates over 2e-5)."""
    from lmsf_slam_tpu_torch.common import se3 as port_se3
    from lmsf_slam_tpu_torch.datasets import SimWorld, simulate_scan_moving
    from benchmark.gen import moving, sim

    sensor = {"rings": 8, "width": 180, "max_range": 60.0}
    tr = traffic.Traffic(dict(TINY_TURN, sweep_motion="moving"), sensor, 5, "cpu", 20)
    normals = torch.randn(8 * 180, generator=torch.Generator().manual_seed(3))
    w = tr.world
    theirs = simulate_scan_moving(SimWorld(w["boxes_min"], w["boxes_max"], w["cylinders"],
                                           w["ground_z"]), tr.poses[6], tr.poses[7], normals,
                                  rings=8, width=180, max_range=60.0, device="cpu")
    p0, p1 = (torch.as_tensor(p) for p in (tr.poses[6], tr.poses[7]))
    rel = (torch.arange(180, dtype=torch.float32) + 0.5) / 180
    xi = port_se3.pose_log(port_se3.pose_between(p0, p1))
    port_cols = port_se3.pose_compose(p0[None], port_se3.se3_exp(rel[:, None] * xi[None]))
    cols = moving.column_poses(180, tr.poses[6], tr.poses[7], "cpu")
    torch.testing.assert_close(cols, port_cols, rtol=0, atol=2e-5)
    r = sim.Renderer(device="cpu", **sensor)
    cast = moving.cast_columns(r, w, port_cols, normals)
    assert torch.equal(cast[1], theirs.mask)
    torch.testing.assert_close(cast[0], theirs.xyz, rtol=0, atol=2e-5)
    ours = moving.scan_moving(r, w, tr.poses[6], tr.poses[7], normals)
    assert torch.equal(ours[1], theirs.mask)
    torch.testing.assert_close(ours[0], theirs.xyz, rtol=0, atol=1e-3)
    torch.testing.assert_close(ours[2], theirs.attr, rtol=0, atol=0)
    # frame 0 stays static, later frames are blurred, and the noise is the seed's
    static = traffic.Traffic(TINY_TURN, sensor, 5, "cpu", 20)
    assert all(torch.equal(a, b) for a, b in zip(tr.scan(0), static.scan(0)))
    assert not torch.equal(tr.scan(7)[0], static.scan(7)[0])


def test_imu_windows_repeat_from_the_seed_alone():
    sensor = {"rings": 8, "width": 120, "max_range": 60.0}
    mix = dict(TINY_TURN, imu=IMU)
    a = traffic.Traffic(mix, sensor, 2**31 + 3, "cpu", 40)
    b = traffic.Traffic(mix, sensor, 2**31 + 3, "cpu", 40)
    assert a.imu(0) is None and traffic.Traffic(TINY_TURN, sensor, 1, "cpu", 40).imu(5) is None
    for k in (1, 39):
        wa, wb = a.imu(k), b.imu(k)
        assert [x.dtype for x in wa] == [np.float32] * 3 and wa[0].shape == (10, 3)
        assert all(np.array_equal(x, y) for x, y in zip(wa, wb))
    # the last frame's window does not depend on the run's length
    longer = traffic.Traffic(mix, sensor, 2**31 + 3, "cpu", 80)
    assert all(np.array_equal(x, y) for x, y in zip(a.imu(39), longer.imu(39)))
    assert not np.array_equal(a.imu(5)[0], traffic.Traffic(mix, sensor, 7, "cpu", 40).imu(5)[0])


# the first three scan tensors of frames 0, 1 and 37 of the committed mixes at
# the committed sensors, hashed on the commit before ``imu`` and
# ``sweep_motion`` existed (sha256, first 32 hex digits)
SCAN_HASHES = {
    ("vlp16_default.revisit", 2**31 + 4099): "3527bf598d72e7bb4933ad2f50ad5c9b",
    ("vlp16_default.revisit", 7340033): "c11d54924579b172c81db4204bb665e4",
    ("hdl64_city.paced", 2**31 + 4099): "33764500b9acc9b28820795821dd5c43",
    ("hdl64_city.paced", 7340033): "e6c6a210db83b146a085686d0e5c98c9",
    ("vlp16_default.explore", 2**31 + 4099): "74b39887d13c35a11f01acec8eab8630",
    ("vlp16_default.explore", 7340033): "58e6e90c9c594441d3d4359a4ec8f697",
}


@pytest.mark.parametrize("workload,seed", sorted(SCAN_HASHES))
def test_committed_mixes_render_what_they_rendered(workload, seed, torch_threads):
    # read from the cell's files by name: the revisit mix and its limits stay
    # committed while BENCHMARK.json holds no cell of them
    name, kind = workload.split(".")
    config = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    mix = json.loads((harness.HERE / "traffic" / f"{kind}.json").read_text())
    tr = traffic.Traffic(mix, config["sensor"], seed, "cpu", traffic.frames_needed(mix, 40.0))
    h = hashlib.sha256()
    for k in (0, 1, 37):
        frame = tr.frame(k)
        assert frame[1] is None
        for t in frame[0]:
            h.update(t.numpy().tobytes())
    assert h.hexdigest()[:32] == SCAN_HASHES[(workload, seed)]
