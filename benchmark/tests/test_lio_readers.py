"""The readers of the IMU-aided step's spans on made-up inputs: the
propagation's, deskew's and correction's milliseconds a frame with the
profiled frames left out, the launches a propagation counted inside the
profiled spans alone, and None where the run has nothing to read."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import importlib.util

import pytest

METRICS = Path(__file__).resolve().parent.parent / "metrics"
MS = 1_000_000  # ns
STAGES = (("lio.propagate", 20), ("lio.deskew", 2), ("lio.register", 60), ("lio.correct", 4))


def reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Span(float):
    """A sample as the program records it: seconds, with a start and a thread."""

    __slots__ = ("start_ns", "thread")


def span(ms, start_ms):
    s = Span(ms * 1e-3)
    s.start_ns, s.thread = round(start_ms * MS), 1
    return s


def run_ctx(trace=True):
    """Frames 0..5, 200 ms apart, each 100 ms; frame 0 has no IMU window and
    records only ``lio.register`` and ``lio.correct``. From 5 ms into each
    later frame: propagate 20, deskew 2, register 60, correct 4 ms. Frames 2
    and 3 are profiled and take twice as long in every stage. The trace
    holds, in frame 2, 5 launches inside the propagation, 2 before it and 3
    inside the registration, a copy inside the propagation; in frame 3, 3
    launches inside the propagation (one of them ``cuLaunchKernel``) and 1
    in deskew."""
    stages = {"frame": [], "frame.track": [], **{k: [] for k, _ in STAGES}}
    for k in range(6):
        t0, x = 200 * k, 2 if k in (2, 3) else 1
        stages["frame"].append(span(100 * x, t0))
        stages["frame.track"].append(span(90 * x, t0 + 4 * x))
        at = t0 + 5 * x
        for label, ms in STAGES:
            if k == 0 and label in ("lio.propagate", "lio.deskew"):
                continue
            stages[label].append(span(ms * x, at))
            at += ms * x
    ctx = {"n_frames": 6, "stages": stages}
    if trace:
        # frame 2: propagate [410, 450), deskew [450, 454), register [454, 574)
        # frame 3: propagate [610, 650), deskew [650, 654)
        runtime = ([("cudaLaunchKernel", (411 + i) * MS, 10_000, 9) for i in range(5)]
                   + [("cudaLaunchKernel", (401 + i) * MS, 10_000, 9) for i in range(2)]
                   + [("cudaLaunchKernel", (460 + i) * MS, 10_000, 9) for i in range(3)]
                   + [("cudaMemcpyAsync", 420 * MS, 10_000, 9)]
                   + [("cudaLaunchKernel", 612 * MS, 10_000, 9),
                      ("cuLaunchKernel", 620 * MS, 10_000, 9),
                      ("cudaLaunchKernelExC", 649 * MS, 10_000, 9),
                      ("cudaLaunchKernel", 651 * MS, 10_000, 9)])
        device = [("k", 412 * MS, 1 * MS, 7)]
        cpu = [("aten::add", 400 * MS, 1 * MS, 9), ("aten::mul", 780 * MS, 1 * MS, 9)]
        ctx["trace"] = {"device": device, "runtime": runtime, "cpu": cpu}
    return ctx


@pytest.mark.parametrize("stage, ms", [("propagate", 20.0), ("deskew", 2.0), ("correct", 4.0)])
def test_stage_ms_read_the_window_frames_outside_the_profiled_ones(stage, ms):
    read = reader(f"lio.{stage}_ms")
    # frames 0, 1, 4, 5 counted; frame 0 has no propagation and no deskew
    first = 0 if stage in ("propagate", "deskew") else ms
    assert read(run_ctx()) == pytest.approx((first + 3 * ms) / 4)
    # without a trace every window frame counts, the profiled ones doubled
    assert read(run_ctx(trace=False)) == pytest.approx((first + 7 * ms) / 6)


def test_launches_count_inside_the_profiled_propagations_over_their_number():
    read = reader("lio.propagate_launches")
    # 5 in frame 2's propagation, 3 in frame 3's; launches before it, in the
    # registration and in deskew are not counted, nor a copy
    assert read(run_ctx()) == pytest.approx((5 + 3) / 2)
    ctx = run_ctx()
    ctx["trace"]["runtime"] = [e for e in ctx["trace"]["runtime"] if e[1] > 600 * MS]
    assert read(ctx) == pytest.approx(3 / 2)
    # a propagation during which the worker held a keyframe is left out,
    # with the worker's launches in it
    ctx = run_ctx()
    ctx["stages"]["worker.keyframe"] = [span(30, 425)]
    ctx["trace"]["runtime"] += [("cudaLaunchKernel", (430 + i) * MS, 10_000, 9) for i in range(3)]
    assert read(ctx) == pytest.approx(3 / 1)
    # a worker keyframe between the propagations leaves both counted
    ctx["stages"]["worker.keyframe"] = [span(100, 470)]
    assert read(ctx) == pytest.approx((5 + 3 + 3) / 2)
    # every propagation shared with the worker: nothing to read
    ctx["stages"]["worker.keyframe"] = [span(300, 400)]
    assert read(ctx) is None
    # no launch at all inside the spans
    ctx = run_ctx()
    ctx["trace"]["runtime"] = []
    assert read(ctx) == 0.0


@pytest.mark.parametrize("name", ["lio.propagate_ms", "lio.deskew_ms", "lio.correct_ms",
                                  "lio.propagate_launches"])
def test_nothing_to_read_reads_none(name):
    read = reader(name)
    full = run_ctx()
    # a program that records no LIO span (the parent, or a frame without an IMU)
    no_lio = {k: v for k, v in full["stages"].items() if not k.startswith("lio.")}
    assert read({"n_frames": 6, "stages": no_lio, "trace": full["trace"]}) is None
    # a program whose samples are durations alone (no start, no thread)
    plain = {k: [float(s) for s in v] for k, v in full["stages"].items()}
    assert read({"n_frames": 6, "stages": plain, "trace": full["trace"]}) is None
    if name == "lio.propagate_launches":
        # no trace: nothing profiled to count in
        assert read(run_ctx(trace=False)) is None
