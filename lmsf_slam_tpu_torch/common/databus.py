"""Typed, capacity-bounded pub/sub bus — the DataManager.

Counterpart of ``lmsf_slam_tpu/common/databus.py``: named, type-checked ring
buffers registered once with a fixed capacity, a producer ``publish`` and
consumer ``read`` / ``read_all`` API, thread-safe; each consumer holds its own
cursor so multiple readers are safe.

For raw float32 payloads crossing the host pipeline at rate, prefer the
native ring (:class:`..native.NativeRing`); this bus is the typed
orchestration layer the app/system code exchanges results over.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional, Type


class DataBus:
    """Named bounded channels with per-consumer cursors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._channels: Dict[str, deque] = {}
        self._types: Dict[str, Type] = {}
        self._caps: Dict[str, int] = {}
        self._seq: Dict[str, int] = {}  # total published per channel
        self._cursors: Dict[str, Dict[str, int]] = {}

    def register(self, name: str, dtype: Type, capacity: int = 16):
        """Create a channel (reference `Registration<T>(name, cap)`)."""
        with self._lock:
            if name in self._channels:
                raise ValueError(f"channel {name!r} already registered")
            self._channels[name] = deque(maxlen=capacity)
            self._types[name] = dtype
            self._caps[name] = capacity
            self._seq[name] = 0
            self._cursors[name] = {}

    def publish(self, name: str, value: Any):
        """Append to a channel (reference `AddData`); oldest entries drop
        when the capacity bound is hit."""
        with self._lock:
            if name not in self._channels:
                raise KeyError(name)
            if not isinstance(value, self._types[name]):
                raise TypeError(
                    f"channel {name!r} carries {self._types[name].__name__}, "
                    f"got {type(value).__name__}"
                )
            self._channels[name].append((self._seq[name], value))
            self._seq[name] += 1

    def read(self, name: str, consumer: str = "default") -> Optional[Any]:
        """Next unseen entry for this consumer, or None."""
        with self._lock:
            q = self._channels[name]
            cur = self._cursors[name].get(consumer, -1)
            for seq, v in q:
                if seq > cur:
                    self._cursors[name][consumer] = seq
                    return v
            return None

    def read_all(self, name: str, consumer: str = "default") -> list:
        """Every unseen entry for this consumer (drains the cursor)."""
        out = []
        while True:
            v = self.read(name, consumer)
            if v is None:
                return out
            out.append(v)

    def latest(self, name: str) -> Optional[Any]:
        with self._lock:
            q = self._channels[name]
            return q[-1][1] if q else None

    def size(self, name: str) -> int:
        with self._lock:
            return len(self._channels[name])
