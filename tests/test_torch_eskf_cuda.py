"""The ESKF propagation kernel (``lmsf_slam_tpu_torch/csrc/eskf.cu``) against
its plain version, ``eskf_run``'s loop of ``eskf_predict``, both on the card:
windows of 1, 10 and 37 samples from a state at rest, from one with an
attitude and bias offset, and from that one with a zero covariance (the bias
blocks' process noise, 1e-10 and 1e-12 a step, is below one float32 rounding
of their initial variances: only from zero does each block's noise show at
its own scale); windows that trip the LIO
tracker's failure gate (speed over 30 m/s, bias over 1); the LiDAR-inertial
city cell's own 100 Hz windows (``benchmark/traffic/paced_imu.json``), each
from the course's pose and velocity at the window's start, with the initial
and with a zero covariance; the tracker's
window as it hands it over (strided slices of one copy). Two launches agree
bit for bit, and each window is one launch.

Tolerances (``kernel_cases.eskf_gaps``, which phase lio holds the kernel to
as well), float32 on both sides. The nominal state is rounded operation by
operation as the plain version rounds it, but the plain version's cross
products, 3×3 products and norms are torch kernels whose sums and fused
multiply-adds need not be the kernel's, so the two may part by a rounding
a step:
- position: 1e-6 m plus 1e-6 of |p| (a few float32 units of the
  position's last place over ten steps; the city's positions reach ~150 m);
- velocity: 1e-6 m/s plus 1e-6 of |v|, for the same reason;
- attitude: 1e-6 rad between the two quaternions;
- biases: equal (both pass them through);
- covariance: each entry P_rc within 1e-5 · sqrt(P_rr P_cc), the scale of
  its own correlation, plus 1e-30 (so that entries whose variances are 0 on
  both sides, the position block after one step from zero, must be 0).
  ``F P Fᵀ`` is summed with fused multiply-adds in k order here and by cuBLAS
  there; over 37 steps another order of the same float32 sums moves an entry
  by up to ~1.5e-6 of that scale (a CPU model of both orders), and an entry
  that cancels towards 0 keeps its accuracy only on that scale.

Marked ``cuda``: it skips without a card. This file imports no JAX:

    python -m pytest tests/test_torch_eskf_cuda.py -m cuda --noconftest -q
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import kernel_cases
from benchmark import traffic
from benchmark.gen import city, imu
from lmsf_slam_tpu_torch import _build
from lmsf_slam_tpu_torch.estimator import eskf as pe
from lmsf_slam_tpu_torch.lio.lio_tracker import LioConfig, LioTracker

ROOT = Path(__file__).resolve().parents[1]
CITY_SEED = 2**31 + 2107  # the cell's noise of window k is drawn from (seed, 3, k)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the ESKF kernel runs only on one")
    return torch.device("cuda")


window = kernel_cases.eskf_window


def start(kind):
    """The filter's state at rest, with an offset, or with the offset and a
    zero covariance."""
    st = kernel_cases.eskf_start(kind != "rest", "cuda")
    return st._replace(cov=torch.zeros_like(st.cov)) if kind == "zero_cov" else st


def on(dev, *xs):
    return tuple(torch.as_tensor(x).to(dev) for x in xs)


def pair(st, gyro, acc, dts, config=pe.EskfConfig()):
    """(kernel, plain) of one window on the card, synchronised."""
    got = pe.eskf_propagate(st, gyro, acc, dts, config)
    want = kernel_cases.eskf_plain(st, gyro, acc, dts, config)
    torch.cuda.synchronize()
    return got, want


def assert_close(got, want, what=""):
    g = kernel_cases.eskf_gaps(got, want)
    assert max(g.values()) <= 1.0, f"{what}: gaps over their tolerances {g}"
    return g


def city_windows(frames=120):
    """The city cell's windows 1..frames-1 and the course's state at each
    window's start: (q, p, world velocity) of frame k − 1."""
    mix = json.loads((ROOT / "benchmark" / "traffic" / "paced_imu.json").read_text())
    spec = mix["imu"]
    poses = city.make_city_course()[:frames + 1]
    v, yaw = imu.course_rates(poses, 1.0 / traffic.FRAME_DT)
    for k in range(1, frames):
        rng = np.random.default_rng(traffic._seed64(CITY_SEED, 3, k))
        w = imu.imu_window(v, yaw, k, rng, scan_hz=1.0 / traffic.FRAME_DT,
                           imu_hz=spec["rate_hz"], gyro_noise=spec["gyro_noise"],
                           acc_noise=spec["acc_noise"])
        yield w, poses[k - 1], v[k - 1]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rest", "offset", "zero_cov"])
@pytest.mark.parametrize("n", [1, 10, 37])
def test_kernel_matches_plain_on_card(n, kind):
    dev = _card()
    got, want = pair(start(kind), *on(dev, *window(n, 10 * n + (kind != "rest"))))
    assert_close(got, want, f"{n} samples")


@pytest.mark.cuda
@pytest.mark.parametrize("v,ba", [(35.0, 0.0), (8.0, 1.2)], ids=["speed", "bias"])
def test_window_that_trips_the_failure_gate_on_card(v, ba):
    dev = _card()
    lio = LioTracker(LioConfig(), device=dev)
    st = start("offset")
    st = st._replace(v=torch.tensor([v, 0.5, 0.0], device=dev),
                     ba=torch.tensor([ba, 0.0, 0.01], device=dev))
    got, want = pair(st, *on(dev, *window(10, 7)))
    assert_close(got, want, "failure gate")
    assert bool(lio._failed(got)) and bool(lio._failed(want))


@pytest.mark.cuda
def test_city_cell_windows_on_card():
    dev = _card()
    worst = {}
    for k, ((gyro, acc, dts), pose, vel) in enumerate(city_windows(), start=1):
        for kind in ("offset", "zero_cov"):
            st = start(kind)._replace(
                q=torch.as_tensor(pose[:4], dtype=torch.float32, device=dev),
                p=torch.as_tensor(pose[4:], dtype=torch.float32, device=dev),
                v=torch.as_tensor(vel, dtype=torch.float32, device=dev))
            g = assert_close(*pair(st, *on(dev, gyro, acc, dts)), f"city window {k}, {kind}")
            worst = {n: max(x, worst.get(n, 0.0)) for n, x in g.items()}
    print("city windows, largest gaps over their tolerances:", worst)


@pytest.mark.cuda
def test_lio_window_slices_on_card():
    """The tracker's window: one (n, 7) copy whose columns reach the kernel as
    strided slices."""
    dev = _card()
    lio = LioTracker(LioConfig(), device=dev)
    lio.eskf = start("offset")
    gyro, acc, dts = window(10, 11)
    got = lio._propagate(gyro, acc, dts)
    want = kernel_cases.eskf_plain(lio.eskf, *on(dev, gyro, acc, dts), lio.config.eskf)
    torch.cuda.synchronize()
    assert_close(got, want, "tracker window")


@pytest.mark.cuda
def test_two_launches_agree_bit_for_bit_and_count_once_each():
    dev = _card()
    st = start("offset")
    args = on(dev, *window(37, 13))
    pe.eskf_propagate(st, *args)  # built and loaded before counting
    before = _build.launches["eskf"]
    a = pe.eskf_propagate(st, *args)
    b = pe.eskf_propagate(st, *args)
    torch.cuda.synchronize()
    assert _build.launches["eskf"] - before == 2
    for name in pe.EskfState._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    lio = LioTracker(LioConfig(), device=dev)
    lio.eskf = st
    lio._propagate(*window(10, 17))
    assert _build.launches["eskf"] - before == 3
