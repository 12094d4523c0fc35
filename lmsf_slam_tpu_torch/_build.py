"""Build and load the port's CUDA kernels; count their launches.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` beside the
package (the hash is of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded), then loaded with ``ctypes``.
Nothing is built when a module is imported: the first launch builds, and a
failed build raises with the compiler's output.

``launches`` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

launches: dict[str, int] = {}
# per kernel: {"seconds": build time, "ptxas": compiler resource summary}
build_info: dict[str, dict] = {}
_libs: dict[str, ctypes.CDLL] = {}
# guards the build, the handle cache and the launch counts: the frontend and
# the backend's worker thread may both reach a kernel's first launch at once
lock = threading.RLock()


def reset_launches() -> None:
    with lock:
        for name in launches:
            launches[name] = 0


def count_launch(name: str) -> None:
    with lock:
        launches[name] = launches.get(name, 0) + 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin)")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for csrc/<name>.cu; returns (process, tmp output, final path,
    start time), or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, time.perf_counter()


def _finish_build(name: str, job) -> None:
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    build_info[name] = {
        "seconds": time.perf_counter() - t0,
        "ptxas": [ln.strip() for ln in log.splitlines()
                  if "ptxas info" in ln or "spill" in ln],
    }


def build(names) -> None:
    """Build the named kernels, one nvcc per source, all started together."""
    with lock:
        jobs = {n: _start_build(n) for n in names}
        for name, job in jobs.items():
            if job is not None:
                _finish_build(name, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        with lock:
            lib = _libs.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(_lib_path(name)))
                launches.setdefault(name, 0)
                _libs[name] = lib
    return lib
