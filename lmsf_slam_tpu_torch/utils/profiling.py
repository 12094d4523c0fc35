"""The program's span recorder and a device trace.

Counterpart of ``lmsf_slam_tpu/utils/profiling.py``. ``StageTimer`` records
labeled spans: each sample is its duration in seconds (``time.perf_counter``)
and also carries when it began on the Unix clock, the clock ``torch.profiler``
stamps its host and device events with, and the thread that recorded it, so
a span can be placed against a profiler trace without entering the profiler.
A span reads one clock at each end: its start on the Unix clock is its
``perf_counter`` start plus the two clocks' offset, read once when the timer
is made (two reads a span could fall either side of a thread switch and
split a span's start from its duration). A span launches nothing on the card
and reads nothing back: a stage that does not end in a read-back times the
host's enqueue. ``device_trace`` is a ``torch.profiler`` trace of every
thread, written to a directory.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import Optional

import torch

# samples a label keeps, the newest: a lifelong run records a few spans a
# frame, which would otherwise grow without end
MAX_SAMPLES = 4096


class Span(float):
    """One sample: its duration in seconds, with ``start_ns`` (Unix time in
    ns when it began) and ``thread`` (``threading.get_ident()`` of the thread
    that recorded it). Sums, sorts and comparisons read the duration."""

    __slots__ = ("start_ns", "thread")


def _unix_minus_perf_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of a
    few pairs of reads."""
    pairs = []
    for _ in range(5):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        pairs.append((b - a, unix - (a + b) // 2))
    return min(pairs)[1]


class StageTimer:
    """Aggregating span recorder: ``with timer("stage"): ...``. ``samples``
    maps a label to its last ``MAX_SAMPLES`` spans, oldest first."""

    def __init__(self):
        self.samples = defaultdict(functools.partial(deque, maxlen=MAX_SAMPLES))
        self._unix_ns = _unix_minus_perf_ns()

    @contextlib.contextmanager
    def __call__(self, label: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add(label, (time.perf_counter_ns() - t0) * 1e-9, t0 + self._unix_ns)

    def add(self, label: str, seconds: float, start_ns: Optional[int] = None):
        """Record a span measured elsewhere (``start_ns``: Unix ns); without
        ``start_ns`` it is taken to have ended now."""
        if start_ns is None:
            start_ns = time.perf_counter_ns() + self._unix_ns - round(seconds * 1e9)
        span = Span(seconds)
        span.start_ns = start_ns
        span.thread = threading.get_ident()
        self.samples[label].append(span)

    def stats(self) -> dict:
        out = {}
        for label, xs in self.samples.items():
            xs_sorted = sorted(xs)
            n = len(xs)
            out[label] = {
                "n": n,
                "mean_ms": 1e3 * sum(xs) / n,
                "median_ms": 1e3 * xs_sorted[n // 2],
                "max_ms": 1e3 * xs_sorted[-1],
                "total_s": sum(xs),
            }
        return out

    def report(self) -> str:
        rows = ["stage                          n    mean     median   max"]
        for label, s in sorted(self.stats().items()):
            rows.append(
                f"{label:<28} {s['n']:>4}  {s['mean_ms']:>7.2f}ms"
                f" {s['median_ms']:>7.2f}ms {s['max_ms']:>7.2f}ms"
            )
        return "\n".join(rows)

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.stats(), f, indent=2)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the block, host activity of every thread
    (the backend's worker too) and, when a card is present, device activity,
    written to ``log_dir/trace.json`` in Chrome's trace format; yields the
    profiler. A no-op yielding None when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
