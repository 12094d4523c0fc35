"""The readers of the program's spans on made-up inputs: the frame stages'
milliseconds a frame, the worker's overlap with the frames, the device's idle
share inside the profiled frames and the queue wait; None where the run has
nothing to read; the profiled frames left out of the window's readings."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import importlib.util

import pytest

METRICS = Path(__file__).resolve().parent.parent / "metrics"
MS = 1_000_000  # ns
FRAME_THREAD, WORKER_THREAD = 1, 2


def reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Span(float):
    """A sample as the program records it: seconds, with a start and a thread."""

    __slots__ = ("start_ns", "thread")


def span(ms, start_ms, thread=FRAME_THREAD):
    s = Span(ms * 1e-3)
    s.start_ns, s.thread = round(start_ms * MS), thread
    return s


def run_ctx(trace=True):
    """Frames 0..5, 200 ms apart, each 80 ms: featurize 10, track 55,
    read-back 5, hand-off 10 ms. Frames 2 and 3 are profiled and take twice
    as long in every stage. A keyframe in frames 0, 2 and 4: the worker holds
    each for 60 ms from 40 ms into the frame, after a wait of 2 ms (frame
    2's: 7 ms). The trace runs from 50 us into frame 2 to 751 ms, in frame 3.
    The device runs 30 ms of frame 2 (two kernels that overlap), 10 ms of
    frame 3 and 10 ms between them."""
    stages = {k: [] for k in ("frame", "frame.featurize", "frame.track", "frame.read_back",
                              "frame.handoff", "worker.keyframe", "worker.queue_wait")}
    for k in range(6):
        t0, x = 200 * k, 2 if k in (2, 3) else 1
        stages["frame"].append(span(80 * x, t0))
        at = t0
        for label, ms in (("frame.featurize", 10), ("frame.track", 55), ("frame.read_back", 5),
                          ("frame.handoff", 10)):
            stages[label].append(span(ms * x, at))
            at += ms * x
        if k % 2 == 0:
            wait = 7 if k == 2 else 2
            stages["worker.queue_wait"].append(span(wait, t0 + 40 - wait, WORKER_THREAD))
            stages["worker.keyframe"].append(span(60, t0 + 40, WORKER_THREAD))
    ctx = {"n_frames": 6, "stages": stages}
    if trace:
        device = [("k1", 410 * MS, 20 * MS, 7), ("k2", 420 * MS, 20 * MS, 7),
                  ("k3", 600 * MS, 10 * MS, 7), ("k4", 570 * MS, 10 * MS, 7)]
        cpu = [("aten::add", 400 * MS + 50_000, 1 * MS, 0), ("aten::mul", 750 * MS, 1 * MS, 0)]
        ctx["trace"] = {"device": device, "runtime": [], "cpu": cpu}
    return ctx


@pytest.mark.parametrize("stage, ms", [("featurize", 10.0), ("track", 55.0), ("read_back", 5.0),
                                       ("handoff", 10.0)])
def test_frame_stages_read_the_window_frames_outside_the_profiled_ones(stage, ms):
    read = reader(f"frame.{stage}_ms")
    # frames 0, 1, 4, 5. Frame 2 starts 50 us before the trace's first event
    # and still counts among the profiled frames: its spans overlap the trace
    assert read(run_ctx()) == pytest.approx(ms)
    # without a trace every window frame counts: 6 frames, two of them doubled
    assert read(run_ctx(trace=False)) == pytest.approx(ms * 8 / 6)


def test_the_stages_sum_to_the_frame():
    ctx = run_ctx()
    total = sum(reader(f"frame.{s}_ms")(ctx) for s in ("featurize", "track", "read_back",
                                                         "handoff"))
    assert total == pytest.approx(80.0)


def test_worker_overlap_is_the_share_of_frame_time_the_worker_held():
    read = reader("frame.worker_overlap_share")
    # frames 0 and 4: [40, 80) of each held; frames 1 and 5: none; 80 of 320 ms
    assert read(run_ctx()) == pytest.approx(25.0)
    # a worker span that begins in profiled frame 3 and ends in frame 4
    # ([700, 820)) holds 20 ms of frame 4
    ctx = run_ctx()
    ctx["stages"]["worker.keyframe"][1] = span(120, 700, WORKER_THREAD)
    assert read(ctx) == pytest.approx(100.0 * (40 + 40 + 20) / 320)
    # a span on the frame's own thread is not the worker's
    ctx = run_ctx()
    for s in ctx["stages"]["worker.keyframe"]:
        s.thread = FRAME_THREAD
    assert read(ctx) == 0.0


def test_device_idle_in_frame_reads_the_profiled_frames_alone():
    read = reader("device.idle_in_frame_share")
    # frame 2 [400, 560): busy [410, 440); frame 3 [600, 760): busy [600, 610);
    # k4 runs between them; 40 of 320 ms busy
    assert read(run_ctx()) == pytest.approx(87.5)
    ctx = run_ctx()
    ctx["trace"]["device"] = []
    assert read(ctx) is None
    assert read(run_ctx(trace=False)) is None


def test_queue_wait_is_the_mean_outside_the_profiled_frames():
    read = reader("worker.queue_wait_ms")
    assert read(run_ctx()) == pytest.approx(2.0)  # frame 2's 7 ms wait left out
    assert read(run_ctx(trace=False)) == pytest.approx((2 + 7 + 2) / 3)


@pytest.mark.parametrize("name", ["frame.featurize_ms", "frame.track_ms", "frame.read_back_ms",
                                  "frame.handoff_ms", "frame.worker_overlap_share",
                                  "device.idle_in_frame_share", "worker.queue_wait_ms"])
def test_nothing_to_read_reads_none(name):
    read = reader(name)
    full = run_ctx()
    # a program that records no such span
    assert read({"n_frames": 6, "stages": {}, "trace": full["trace"]}) is None
    # a program whose samples are durations alone (no start, no thread)
    plain = {k: [float(s) for s in v] for k, v in full["stages"].items()}
    assert read({"n_frames": 6, "stages": plain, "trace": full["trace"]}) is None
