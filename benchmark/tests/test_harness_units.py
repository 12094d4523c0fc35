"""The harness's arithmetic on made-up inputs: the window's rate and
percentiles, open-loop latency from the due time, the idle share, the k-NN
roofline, the isolation check, and the frozen generators' determinism."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, traffic

METRICS = Path(__file__).resolve().parent.parent / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FakeSystem:
    """A system whose frames take ``frame_s`` (``stall`` maps a frame to a
    longer time) and whose flush takes ``flush_s``."""

    def __init__(self, frame_s, flush_s, stall=None):
        self.frame_s, self.flush_s, self.stall = frame_s, flush_s, stall or {}
        self.k = 0

    def flush(self):
        time.sleep(self.flush_s)


class FakeSut:
    @staticmethod
    def process(system, scan, stamp):
        time.sleep(system.stall.get(system.k, system.frame_s))
        system.k += 1
        return stamp

    @staticmethod
    def backlog(system):
        return 0


def test_closed_window_rate_counts_the_final_flush():
    system = FakeSystem(0.01, 0.3)
    w = harness.closed_window(FakeSut, system, traffic.Traffic, [None] * 500, 0, 0.2)
    n = len(w["results"])
    assert 10 <= n <= 21
    # the window's time holds the frames and the 0.3 s flush
    assert w["window_s"] >= 0.2 + 0.3
    assert n / w["window_s"] < 0.6 * n / 0.2


def test_closed_window_fails_when_the_pool_runs_out():
    with pytest.raises(RuntimeError, match="used up the pool"):
        harness.closed_window(FakeSut, FakeSystem(0.01, 0.0), traffic.Traffic, [None] * 3, 0, 1.0)


def test_percentiles_are_of_all_frames():
    lat = [i / 1000 for i in range(1, 101)]  # 1..100 ms
    s = harness.latency_stats(lat)
    assert s["frame_p50_ms"] == pytest.approx(50.5)
    assert s["frame_p95_ms"] == pytest.approx(95.05)
    assert harness.quantile([3.0], 0.95) == 3.0


def test_open_loop_latency_runs_from_the_due_time_across_a_stall():
    # 20 frames/s: frame 2 stalls 0.3 s, so frames 3..7 were due while it ran
    system = FakeSystem(0.005, 0.0, stall={2: 0.3})
    w = harness.open_window(FakeSut, system, traffic.Traffic, [None] * 12, 20.0)
    lat = w["latency_s"]
    assert lat[2] == pytest.approx(0.3, abs=0.03)
    # frame 3 was due 0.05 s after frame 2 and waited for the stall to end
    assert lat[3] == pytest.approx(0.3 - 0.05 + 0.005, abs=0.03)
    assert lat[6] == pytest.approx(0.3 - 0.2 + 4 * 0.005, abs=0.03)
    assert lat[11] < 0.03  # caught up again
    assert w["late_s"] == pytest.approx(0.25, abs=0.03)


def test_idle_share_is_the_union_of_device_intervals():
    mod = reader("device.idle_share")
    ev = [("k1", 0, 100, 0), ("k2", 50, 100, 0), ("m", 400, 100, 0), ("k3", 420, 10, 0)]
    ctx = {"trace": {"device": ev, "runtime": [], "cpu": []}, "trace_window_s": 1000e-9}
    # busy: [0,150) and [400,500) = 250 ns of 1000
    assert mod.read(ctx) == pytest.approx(75.0)
    assert harness.union_seconds([(s, d) for _, s, d, _ in ev]) == pytest.approx(250e-9)
    assert harness.idle_gaps([(s, d) for _, s, d, _ in ev]) == [(150, 250)]
    assert mod.read({"trace": None}) is None


def test_knn_roofline_reproduces_the_kernel_table_bound():
    mod = reader("kernel.knn_roofline")
    # PERF.md's row "surf 1536x16384 k=5": 11396 of 16384 references valid
    assert mod.least_seconds(1536, 1536, 16384, 11396, 5) * 1e3 == pytest.approx(0.00209, abs=5e-6)
    calls = [(1536, 1536, 16384, 11396, 5, False)]
    ev = [("knn_partial_kernel(...)", 0, 40_000, 0), ("knn_merge_kernel(...)", 50_000, 10_000, 0),
          ("other", 0, 999_000, 0)]
    share = mod.read({"trace": {"device": ev, "runtime": [], "cpu": []}, "knn_calls": calls})
    assert share == pytest.approx(100 * 2.0903e-6 / 50e-6, rel=1e-3)
    assert mod.read({"trace": {"device": ev[2:], "runtime": [], "cpu": []},
                     "knn_calls": calls}) is None


def test_isolation_compares_whole_top_level_names():
    names = ["lmsf_slam_tpu_torch", "lmsf_slam_tpu_torch.ops", "lmsf_slam_tpu.ops.knn", "jaxlib",
             "jaxtyping", "jax", "flax.linen", "torch"]
    assert harness.forbidden_modules(names) == ["flax.linen", "jax", "jaxlib",
                                                "lmsf_slam_tpu.ops.knn"]


@pytest.mark.parametrize("course", ["circle", "line", "city"])
def test_generators_repeat_bit_for_bit_from_the_seed(course):
    sensor = {"rings": 8, "width": 120, "max_range": 60.0}
    mix = {"course": course, "world": {"extent": 30.0, "n_boxes": 14, "n_cylinders": 24},
           "frames_per_lap": 120, "radius": 9.0, "z": 1.4, "step_m": 0.47, "world_seed": 0}
    seed = 2**31 + 12345
    a = traffic.Traffic(mix, sensor, seed, "cpu", 40)
    b = traffic.Traffic(mix, sensor, seed, "cpu", 40)
    c = traffic.Traffic(mix, sensor, seed + 1, "cpu", 40)
    for k in (0, 17):
        sa, sb, sc = a.scan(k), b.scan(k), c.scan(k)
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))
        assert not torch.equal(sa[0], sc[0])
    # frame 17 does not depend on which frames were drawn before it
    assert torch.equal(traffic.Traffic(mix, sensor, seed, "cpu", 40).scan(17)[0], a.scan(17)[0])
    np.testing.assert_array_equal(a.poses, b.poses)
