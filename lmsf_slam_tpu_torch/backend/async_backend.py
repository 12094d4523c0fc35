"""Asynchronous backend: loop detection + optimization off the frontend path.

Counterpart of ``lmsf_slam_tpu/backend/async_backend.py``. ``submit`` is a
bounded-queue enqueue returning the latest published ``odom2map``
immediately; one worker thread drains keyframes through the wrapped
``LifelongBackend``. The ``odom2map`` correction is published atomically: the
frontend composes its odometry with the latest correction.

Backpressure policy (``policy``): what happens when the worker falls behind
and the queue is full. Quality must not depend on the frontend/backend
wall-clock ratio, so the default policy never drops MAPPING keyframes:

- ``"coalesce"`` (default): while the backend is localizing, a queued
  keyframe's only effect is refreshing ``odom2map``, so a newer scan
  supersedes it. On overflow the newest pending *superseded* item (never one
  carrying a GNSS fix) is replaced by the new one; in MAPPING / with nothing
  supersedable the frontend blocks briefly instead (lossless for the map).
- ``"block"``: always lossless; the frontend eats the latency spike.
- ``"drop"``: shed the new keyframe. Kept for measurement, not production.

Under PyTorch both threads share one interpreter and, on a card, one stream
(each thread's current stream is the device's default stream): the worker's
launches queue behind the frontend's and the reverse, and every read-back
of either thread waits for the work queued before it. Grad mode and the
current device are per thread, so the worker sets both itself. It never
falls back to the sync path or to the CPU: a worker that fails re-raises on
the caller's thread at the next ``submit`` or ``flush``.

The worker records two spans a keyframe on the backend's ``timer``:
``worker.keyframe``, the whole ``add_keyframe`` call (the backend's own
stages nest inside it), and ``worker.queue_wait``, from ``submit`` to the
worker taking the item. An item superseded under ``coalesce`` records none.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..common.pointcloud import PointBatch
from .lifelong import BackendOutput, LifelongBackend, WorkMode


class AsyncBackend:
    """Thread-decoupled facade over :class:`LifelongBackend`.

    API mirrors the sync backend; ``submit`` never blocks on optimization
    (only on a full queue under the lossless policies, which bounds memory).
    """

    def __init__(
        self,
        backend: LifelongBackend,
        max_queue: int = 8,
        policy: str = "coalesce",
        drop_when_full: Optional[bool] = None,
    ):
        """``drop_when_full`` is the legacy switch: True → ``policy="drop"``,
        False → ``policy="block"``; prefer ``policy`` directly."""
        if drop_when_full is not None:
            policy = "drop" if drop_when_full else "block"
        if policy not in ("coalesce", "block", "drop"):
            raise ValueError(f"unknown async policy {policy!r}")
        self.backend = backend
        self.policy = policy
        self.max_queue = max_queue
        self.dropped = 0  # items shed and never processed ("drop" policy)
        self.coalesced = 0  # localization refreshes superseded by newer scans
        self._q: deque = deque()
        self._outstanding = 0  # submitted − completed (for flush)
        self._outputs: list[BackendOutput] = []
        self._cond = threading.Condition()
        self._odom2map = np.asarray(backend.odom2map).copy()
        self._mode = backend.mode
        self._stop = False
        self._error: Optional[BaseException] = None
        # grad mode is per thread: the worker runs under the submitter's
        self._grad = torch.is_grad_enabled()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- worker ---------------------------------------------------------------

    def _thread_state(self):
        """What the backend relies on and PyTorch keeps per thread: the
        current device (the database's card) and the grad mode."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.set_grad_enabled(self._grad))
        dev = getattr(getattr(self.backend, "db", None), "device", None)
        if dev is not None and dev.type == "cuda":
            stack.enter_context(torch.cuda.device(dev))
        return stack

    def _run(self):
        with self._thread_state():
            self._drain()

    def _drain(self):
        while True:
            with self._cond:
                while not self._q and not self._stop:
                    self._cond.wait(timeout=0.1)
                if self._stop and not self._q:
                    return
                if not self._q:
                    continue
                item = self._q.popleft()
                self._cond.notify_all()  # a blocked submitter can proceed
            stamp, edge, surf, odom_pose, gnss_pos, scan_grid, submitted = item
            try:
                # the wait ends now: the span runs back to the submit
                self.backend.timer.add("worker.queue_wait", time.perf_counter() - submitted)
                with self.backend.timer("worker.keyframe"):
                    out = self.backend.add_keyframe(
                        stamp, edge, surf, odom_pose, gnss_pos=gnss_pos,
                        scan_grid=scan_grid,
                    )
                with self._cond:
                    self._outputs.append(out)
                    self._odom2map = np.asarray(self.backend.odom2map).copy()
                    self._mode = self.backend.mode
            except BaseException as exc:  # noqa: BLE001 — surfaced at submit/flush
                # a dead worker must not deadlock the frontend: record the
                # failure, keep draining, and re-raise from the next
                # submit()/flush() on the caller thread
                with self._cond:
                    if self._error is None:
                        self._error = exc
            finally:
                with self._cond:
                    self._outstanding -= 1
                    self._cond.notify_all()

    def _raise_pending_locked(self):
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("async backend worker failed") from err

    # -- frontend API -----------------------------------------------------------

    def submit(
        self, stamp: float, edge: PointBatch, surf: PointBatch, odom_pose,
        gnss_pos=None, scan_grid=None,
    ) -> tuple[np.ndarray, WorkMode, bool]:
        """Enqueue a keyframe; returns (latest odom2map, mode, enqueued).

        ``enqueued`` is False only under the ``"drop"`` policy when the item
        was shed — the caller should re-stash side-channel payloads (e.g. a
        pending GNSS fix) onto the next keyframe. ``gnss_pos``/``scan_grid``:
        optional GNSS observation and organized range image riding with the
        keyframe — same contract as ``LifelongBackend.add_keyframe``. The
        clouds and the range image stay queued while the frontend runs on:
        the caller must not write them in place afterwards."""
        item = (
            stamp,
            edge,
            surf,
            np.asarray(odom_pose, np.float32),
            None if gnss_pos is None else np.asarray(gnss_pos, np.float32),
            scan_grid,
            time.perf_counter(),  # when submitted, for the queue wait
        )
        enqueued = True
        with self._cond:
            self._raise_pending_locked()
            while len(self._q) >= self.max_queue:
                if self.policy == "drop":
                    self.dropped += 1
                    enqueued = False
                    break
                if self.policy == "coalesce" and self._mode in (
                    WorkMode.LOCALIZATION, WorkMode.RELOCALIZATION
                ):
                    # supersede the newest pending refresh that carries no
                    # GNSS payload (a fix must reach the graph exactly once)
                    victim = None
                    for i in range(len(self._q) - 1, -1, -1):
                        if self._q[i][4] is None:
                            victim = i
                            break
                    if victim is not None:
                        del self._q[victim]
                        self._outstanding -= 1  # superseded, never processed
                        self.coalesced += 1
                        continue  # loop re-checks capacity, then enqueues
                # lossless: wait for the worker to free a slot
                self._cond.wait(timeout=0.1)
                self._raise_pending_locked()
            if enqueued:
                self._q.append(item)
                self._outstanding += 1
                self._cond.notify_all()
            return self._odom2map.copy(), self._mode, enqueued

    @property
    def odom2map(self) -> np.ndarray:
        with self._cond:
            return self._odom2map.copy()

    @property
    def mode(self) -> WorkMode:
        with self._cond:
            return self._mode

    @property
    def backlog(self) -> int:
        """Pending keyframes (the adaptive-gate signal)."""
        with self._cond:
            return self._outstanding

    def outputs(self) -> list[BackendOutput]:
        with self._cond:
            return list(self._outputs)

    def flush(self, timeout: Optional[float] = None):
        """Block until every submitted keyframe has been processed."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._outstanding == 0, timeout=timeout
            )
            self._raise_pending_locked()
            self._odom2map = np.asarray(self.backend.odom2map).copy()
            self._mode = self.backend.mode

    def close(self):
        self.flush()
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._worker.join(timeout=5.0)

    # -- passthroughs -------------------------------------------------------------

    @property
    def db(self):
        return self.backend.db

    def force_global_optimize(self):
        self.flush()
        return self.backend.force_global_optimize()

    def save(self, path: str):
        self.flush()
        self.backend.save(path)
