"""Online stream synchronization — the live-robot ingest layer.

Counterpart of ``lmsf_slam_tpu/common/sync.py`` (a copy: importing that
module would run the reference package's ``__init__``):

- :class:`ApproxTimeSync` — N-stream nearest-stamp set matcher with a slop
  bound and bounded queues (jitter + drops tolerated, never blocks);
- :class:`ImuWindowBuffer` — IMU ring buffer returning the [t0, t1] window
  with boundary samples interpolated to the exact edges (the IMU window
  contract of ``MultiLidarSystem.process``);
- :class:`StreamIngest` — facade gluing both onto
  ``MultiLidarSystem.process``: push scans/IMU/GNSS as they arrive, matched
  frames come out (with several LiDARs, the list of matched scans, primary
  first).

Host-side by design: stream bookkeeping is pointer arithmetic, not math —
it must not cost device work (the card sees only the matched frames).
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np


class ApproxTimeSync:
    """Approximate-time N-stream matcher.

    ``push(stream, stamp, payload)`` buffers a message; whenever a set of
    one-message-per-stream with max-min stamp span ≤ ``slop`` can be formed
    at the queue heads, it is emitted (oldest first) via the returned list /
    the ``on_match`` callback. Messages that can no longer participate in
    any future match are discarded, so queues stay bounded by
    ``queue_size`` even when one stream dies entirely.
    """

    def __init__(
        self,
        n_streams: int,
        slop: float = 0.05,
        queue_size: int = 10,
        on_match: Optional[Callable] = None,
    ):
        assert n_streams >= 1
        self.n = n_streams
        self.slop = float(slop)
        self.queue_size = int(queue_size)
        self.on_match = on_match
        self._q: list[deque] = [deque() for _ in range(n_streams)]
        self.dropped = 0  # messages discarded without matching

    def _try_match(self) -> Optional[tuple]:
        if any(not q for q in self._q):
            return None
        # candidate set: for the latest head (pivot), advance every other
        # stream to its element nearest the pivot (ApproximateTime policy)
        pivot = max(q[0][0] for q in self._q)
        for q in self._q:
            while len(q) >= 2 and abs(q[1][0] - pivot) <= abs(q[0][0] - pivot):
                self.dropped += 1
                q.popleft()
        stamps = [q[0][0] for q in self._q]
        if max(stamps) - min(stamps) <= self.slop:
            out = tuple(q.popleft() for q in self._q)
            return out
        # no match possible with the current earliest element — it can only
        # age further from every future pivot, so discard it
        i = int(np.argmin(stamps))
        self._q[i].popleft()
        self.dropped += 1
        return None

    def push(self, stream: int, stamp: float, payload) -> list[tuple]:
        """Returns the list of matched sets completed by this message, each
        a tuple of ``(stamp, payload)`` per stream."""
        q = self._q[stream]
        q.append((float(stamp), payload))
        if len(q) > self.queue_size:
            q.popleft()
            self.dropped += 1
        matches = []
        while True:
            m = self._try_match()
            if m is None:
                # _try_match may have dropped a head; retry while all
                # queues still hold candidates
                if any(not qq for qq in self._q):
                    break
                continue
            matches.append(m)
            if self.on_match is not None:
                self.on_match(m)
        return matches


class ImuWindowBuffer:
    """IMU sample buffer with boundary interpolation to exact window edges
    (the reference's sensor-interval slicing, `sensor.hpp:101-117`)."""

    def __init__(self, max_samples: int = 4096):
        self._t: deque = deque(maxlen=max_samples)
        self._gyro: deque = deque(maxlen=max_samples)
        self._acc: deque = deque(maxlen=max_samples)

    def push(self, stamp: float, gyro, acc):
        self._t.append(float(stamp))
        self._gyro.append(np.asarray(gyro, np.float32))
        self._acc.append(np.asarray(acc, np.float32))

    def window(self, t0: float, t1: float):
        """Samples covering [t0, t1]: interior samples plus boundary samples
        linearly interpolated to exactly t0 and t1. Returns
        (gyro (M,3), acc (M,3), dts (M,)) ready for the ESKF/preintegration
        path (dts[i] = t_i − t_{i−1}, dts[0] = 0), or None when the buffer
        does not span the window."""
        t = np.asarray(self._t, np.float64)
        if t.size < 2 or t[0] > t0 or t[-1] < t1:
            return None
        g = np.stack(list(self._gyro))
        a = np.stack(list(self._acc))

        def interp(ts):
            gi = np.stack([np.interp(ts, t, g[:, k]) for k in range(3)], -1)
            ai = np.stack([np.interp(ts, t, a[:, k]) for k in range(3)], -1)
            return gi.astype(np.float32), ai.astype(np.float32)

        inside = (t > t0) & (t < t1)
        ts = np.concatenate([[t0], t[inside], [t1]])
        gi, ai = interp(ts)
        dts = np.diff(ts, prepend=ts[0]).astype(np.float32)
        return gi, ai, dts

    def drop_before(self, t0: float):
        """Release samples older than ``t0`` (keep one for interpolation)."""
        while len(self._t) >= 2 and self._t[1] <= t0:
            self._t.popleft()
            self._gyro.popleft()
            self._acc.popleft()


class StreamIngest:
    """Live ingest facade over :class:`MultiLidarSystem`.

    Push sensor messages as they arrive (any order/jitter within the slop):

    - ``push_scan(lidar_idx, stamp, scan)`` — per-lidar point clouds;
    - ``push_imu(stamp, gyro, acc)`` — IMU samples (used when the system is
      configured with ``use_imu``);
    - ``push_gnss(stamp, lla)`` — GNSS fixes (forwarded on arrival).

    When one scan per lidar is matched within ``slop``, the system processes
    the frame (stamped with the primary's stamp, the reference's convention)
    with the IMU window since the previous matched frame. Returns the
    FrameResults emitted by this push.
    """

    def __init__(self, system, slop: float = 0.05, queue_size: int = 10):
        self.system = system
        n = system.config.n_lidars
        self._sync = ApproxTimeSync(n, slop=slop, queue_size=queue_size)
        self._imu = ImuWindowBuffer()
        self._last_stamp: Optional[float] = None
        self.results = []

    def push_imu(self, stamp: float, gyro, acc):
        self._imu.push(stamp, gyro, acc)

    def push_gnss(self, stamp: float, lla, pos_std: float = 0.1):
        self.system.process_gnss(np.asarray(lla), pos_std=pos_std)

    def push_scan(self, lidar_idx: int, stamp: float, scan) -> list:
        out = []
        for match in self._sync.push(lidar_idx, stamp, scan):
            t = match[0][0]  # primary lidar's stamp
            scans = [payload for _, payload in match]
            if len(scans) == 1:
                scans = scans[0]
            kw = {}
            if self.system.config.use_imu and self._last_stamp is not None:
                w = self._imu.window(self._last_stamp, t)
                if w is not None:
                    gi, ai, dts = w
                    kw = dict(gyro=gi, acc=ai, imu_dts=dts)
            res = self.system.process(scans, t, **kw)
            self._imu.drop_before(t)
            self._last_stamp = t
            out.append(res)
            self.results.append(res)
        return out

    @property
    def dropped(self) -> int:
        return self._sync.dropped
