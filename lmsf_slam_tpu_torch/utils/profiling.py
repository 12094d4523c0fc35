"""Aggregated stage timers and a device trace.

Counterpart of ``lmsf_slam_tpu/utils/profiling.py``: ``StageTimer``, labeled
wall-clock aggregation with mean/median/max and JSON/CSV export, and
``device_trace``, a ``torch.profiler`` trace written to a directory. Launches on
a card return before the device finishes, so a stage that should measure
execution rather than enqueueing passes ``block_on`` (a tensor, a device, or
anything true): the timer then calls ``torch.cuda.synchronize()`` before it
stops the clock. A stage that already ends in a read-back needs none.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Optional

import torch


def _synchronize(block_on) -> None:
    """Wait for the card that ``block_on`` names (a tensor or a device); a
    CPU tensor or device needs no wait."""
    device = getattr(block_on, "device", block_on)
    if isinstance(device, (str, torch.device)):
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    elif torch.cuda.is_available():
        torch.cuda.synchronize()


class StageTimer:
    """Aggregating wall-clock timer: ``with timer("stage"): ...``."""

    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, label: str, block_on=None):
        """Time a stage; pass ``block_on=<tensor or device>`` to synchronize
        the card before stopping the clock (measures execution, not enqueue)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.samples[label].append(time.perf_counter() - t0)

    def add(self, label: str, seconds: float):
        self.samples[label].append(seconds)

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

    def save_csv(self, path: str, label: str):
        """Per-sample CSV of one stage, milliseconds, one sample a line."""
        with open(path, "w") as f:
            f.write(f"{label}\n")
            for x in self.samples[label]:
                f.write(f"{x * 1e3:.3f}\n")


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the block, host and (when a card is
    present) device activity, written to ``log_dir/trace.json`` in Chrome's
    trace format; yields the profiler. A no-op yielding None when
    ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
