"""ctypes bindings for the native data-plane library (``native/lmsf_io.cpp``).

Counterpart of ``lmsf_slam_tpu/native/bindings.py``: raw float32 files
(KITTI ``.bin`` scans), binary PCD, a single-producer single-consumer ring
buffer of float32 payloads and a background-thread file prefetcher, all in
C++ behind a C ABI.

The library is compiled from the repository's ``native/lmsf_io.cpp`` by
``g++`` at first use into ``build/native/liblmsf_io-<hash>.so`` beside the
port's kernels (the hash is of the source and the flags, so an edited source
is rebuilt), never into ``native/``. Nothing is built at import. A failed
build raises with the compiler's output: there is no numpy fallback.
``native_available()`` reports whether the library builds and loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SRC = _REPO / "native" / "lmsf_io.cpp"
BUILD_DIR = _REPO / "build" / "native"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_I64, _PTR, _STR = ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
_SIGNATURES = {
    "lmsf_read_f32": (_I64, [_STR, _PTR, _I64]),
    "lmsf_file_size": (_I64, [_STR]),
    "lmsf_write_pcd": (ctypes.c_int, [_STR, _PTR, _I64]),
    "lmsf_read_pcd": (_I64, [_STR, _PTR, _I64]),
    "lmsf_ring_create": (_PTR, [_I64, _I64]),
    "lmsf_ring_destroy": (None, [_PTR]),
    "lmsf_ring_push": (ctypes.c_int, [_PTR, _PTR, _I64]),
    "lmsf_ring_pop": (_I64, [_PTR, _PTR]),
    "lmsf_ring_size": (_I64, [_PTR]),
    "lmsf_prefetch_create": (_PTR, [ctypes.POINTER(_STR), ctypes.c_int, _I64, _I64]),
    "lmsf_prefetch_next": (_I64, [_PTR, _PTR, _I64]),
    "lmsf_prefetch_destroy": (None, [_PTR]),
}


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"liblmsf_io-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC} (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def native_available() -> bool:
    """True when the library builds (or is built) and loads."""
    try:
        _load()
    except (RuntimeError, OSError, FileNotFoundError):
        return False
    return True


def read_f32(path: str, max_floats: Optional[int] = None) -> np.ndarray:
    """Raw float32 file (KITTI .bin payload)."""
    lib = _load()
    if max_floats is None:
        size = lib.lmsf_file_size(path.encode())
        if size < 0:
            raise IOError(path)
        max_floats = size // 4
    out = np.empty(max_floats, np.float32)
    n = lib.lmsf_read_f32(path.encode(), out.ctypes.data, max_floats)
    if n < 0:
        raise IOError(path)
    return out[:n]


def write_pcd(path: str, xyz: np.ndarray):
    """Binary PCD v0.7 (x y z) — the keyframe-cloud format."""
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    if _load().lmsf_write_pcd(path.encode(), xyz.ctypes.data, xyz.shape[0]) != 0:
        raise IOError(path)


def read_pcd(path: str, max_points: int = 1 << 22) -> np.ndarray:
    """The (n, 3) float32 points of a binary PCD file."""
    out = np.empty((max_points, 3), np.float32)
    n = _load().lmsf_read_pcd(path.encode(), out.ctypes.data, max_points)
    if n < 0:
        raise IOError(path)
    return out[:n].copy()


class NativeRing:
    """SPSC ring buffer of float32 payloads (the DataManager bus's transport)."""

    def __init__(self, slot_floats: int, n_slots: int):
        self._lib = _load()
        self.slot_floats = slot_floats
        self._h = self._lib.lmsf_ring_create(slot_floats * 4, n_slots)

    def push(self, arr: np.ndarray) -> bool:
        """False when the ring is full; raises when the payload exceeds a slot."""
        arr = np.ascontiguousarray(arr, np.float32)
        rc = self._lib.lmsf_ring_push(self._h, arr.ctypes.data, arr.nbytes)
        if rc == -2:
            raise ValueError("payload exceeds slot size")
        return rc == 0

    def pop(self) -> Optional[np.ndarray]:
        out = np.empty(self.slot_floats, np.float32)
        n = self._lib.lmsf_ring_pop(self._h, out.ctypes.data)
        if n < 0:
            return None
        return out[: n // 4].copy()

    def __len__(self):
        return int(self._lib.lmsf_ring_size(self._h))

    def close(self):
        if getattr(self, "_h", None):
            self._lib.lmsf_ring_destroy(self._h)
            self._h = None

    __del__ = close


class ScanPrefetcher:
    """Background-thread file prefetcher: iterate (n_floats,) float32 arrays
    in file order while disk reads overlap compute."""

    def __init__(self, paths: list[str], slot_floats: int = 1 << 19, n_slots: int = 4):
        self._lib = _load()
        self.slot_floats = slot_floats
        # the C side copies the paths before this returns
        arr = (_STR * len(paths))(*[p.encode() for p in paths])
        self._h = self._lib.lmsf_prefetch_create(arr, len(paths), slot_floats * 4, n_slots)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        out = np.empty(self.slot_floats, np.float32)
        n = self._lib.lmsf_prefetch_next(self._h, out.ctypes.data, self.slot_floats)
        if n < 0:
            raise StopIteration
        return out[:n].copy()

    def close(self):
        if getattr(self, "_h", None):
            self._lib.lmsf_prefetch_destroy(self._h)
            self._h = None

    __del__ = close
