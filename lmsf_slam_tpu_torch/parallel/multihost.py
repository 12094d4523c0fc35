"""Bootstrap of several processes: the process group, its mesh, host shards.

Counterpart of ``lmsf_slam_tpu/parallel/multihost.py``. The reference scales
across machines with a multi-node ROS graph; the port, like the JAX package,
runs one program in every process (SPMD). Where the reference calls
``jax.distributed.initialize``, the port makes a ``torch.distributed``
process group, and :func:`global_mesh` spans its ranks.

Every sharded solver of the package takes an explicit mesh, so the only code
that knows about several hosts is this bootstrap. Launches, one command a
process::

    LMSF_COORDINATOR=10.0.0.1:8476 LMSF_NUM_PROCESSES=4 LMSF_PROCESS_ID=$ID \\
        python -m lmsf_slam_tpu_torch.entry --dryrun
    torchrun --nproc-per-node 4 -m lmsf_slam_tpu_torch.entry --dryrun

    # in the program:
    from lmsf_slam_tpu_torch.parallel import multihost
    multihost.initialize_from_env()          # False when nothing is set
    mesh = multihost.global_mesh(axis="graph")

:func:`launch_local` starts several ranks of one function on this host (the
``spawn`` start method), as ``chip_smoke.py`` and the tests do.

The backend is chosen before the group is made (:func:`choose_backend`) and
printed: NCCL when every rank of a host has a card of its own, gloo when
ranks share a card or run on the CPU (NCCL refuses two ranks on one card).
It is never swapped after a failure.
"""
from __future__ import annotations

import os
import socket
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from .distributed import Mesh, make_mesh

_ENV_COORD = "LMSF_COORDINATOR"
_ENV_NPROC = "LMSF_NUM_PROCESSES"
_ENV_PID = "LMSF_PROCESS_ID"
# torchrun's variables: the launcher's counterpart of the pod autodetection
# that jax.distributed.initialize does
_ENV_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def choose_backend(local_ranks: int) -> str:
    """``nccl`` when each of ``local_ranks`` ranks of this host has a card of
    its own, else ``gloo``."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if 0 < local_ranks <= cards else "gloo"


def initialize_from_env(backend: str | None = None, timeout: float = 600.0) -> bool:
    """Join the process group if the launch set one up.

    ``LMSF_COORDINATOR`` (host:port of rank 0), ``LMSF_NUM_PROCESSES`` and
    ``LMSF_PROCESS_ID`` make a group over TCP; without them, torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` make one
    through ``env://``. Returns True when a group is active after the call,
    False for an ordinary single-process run. Safe to call more than once.
    ``timeout`` (s) bounds the group's creation and every collective.
    """
    if dist.is_initialized():
        return True
    coord = os.environ.get(_ENV_COORD)
    if coord is not None:
        kwargs = dict(init_method="tcp://" + coord,
                      world_size=int(os.environ.get(_ENV_NPROC, "1")),
                      rank=int(os.environ.get(_ENV_PID, "0")))
    elif all(k in os.environ for k in _ENV_TORCHRUN):
        kwargs = dict(init_method="env://")
    else:
        return False
    if backend is None:
        backend = choose_backend(int(os.environ.get("LOCAL_WORLD_SIZE", "1")))
    print(f"[multihost] process group over {kwargs['init_method']}, backend {backend}",
          flush=True)
    dist.init_process_group(backend, timeout=timedelta(seconds=timeout), **kwargs)
    return True


def global_mesh(axis: str = "graph", backend: str | None = None) -> Mesh:
    """A 1-D mesh over every rank of the group (a world of one without one)."""
    return make_mesh(None, axis, backend)


def process_info() -> tuple[int, int]:
    """(rank, world size): (0, 1) without a process group. The offline
    mapping gives each process its contiguous slice of the sequence by
    it (the host-sharded ingest the reference gets from rosbag playback)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_bounds(n_items: int) -> tuple[int, int]:
    """[start, end) of this process's contiguous shard of ``n_items`` frames."""
    pid, pn = process_info()
    per = (n_items + pn - 1) // pn
    start = min(pid * per, n_items)
    return start, min(start + per, n_items)


# ---------------------------------------------------------------------------
# Several ranks of one function on this host
# ---------------------------------------------------------------------------


def free_tcp_address() -> str:
    """``tcp://127.0.0.1:<a port that was free a moment ago>``."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


class _Failure(str):
    """The traceback of a rank's exception, sent in place of its result."""


def _rank_main(rank, fn, args, nprocs, backend, init_method, timeout, threads, results):
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init_method, world_size=nprocs, rank=rank,
                            timeout=timedelta(seconds=timeout))
    try:
        try:
            out = fn(*args)
        except BaseException:
            # the first failure reaches the parent before the ranks it brings
            # down report theirs
            results.put((rank, _Failure(traceback.format_exc())))
            raise
        results.put((rank, out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch_local(fn, nprocs: int, args=(), backend: str | None = None,
                 init_method: str | None = None, timeout: float = 600.0,
                 threads: int | None = None) -> list:
    """Run ``fn(*args)`` in ``nprocs`` new processes (``spawn``), each a rank
    of one process group, and return their results in rank order.

    ``fn`` must be importable by name (a module-level function) and should
    return numpy arrays and plain values: a tensor would cross back through
    shared memory that dies with its process. ``backend`` defaults to
    :func:`choose_backend`; ``init_method`` to a free TCP port on this host;
    ``threads`` sets each rank's torch intra-op threads. A rank that raises
    fails the whole launch (the others are stopped) with its traceback, and so
    does a launch that has not ended after ``timeout`` seconds, which also
    bounds the group's creation and each collective. The error names the
    first rank that failed and carries its traceback.
    """
    import torch.multiprocessing as tmp
    from torch.multiprocessing.spawn import ProcessException

    if backend is None:
        backend = choose_backend(nprocs)
    init_method = init_method or free_tcp_address()
    print(f"[multihost] {nprocs} local ranks over {init_method}, backend {backend}", flush=True)
    results = tmp.get_context("spawn").SimpleQueue()
    ctx = tmp.start_processes(
        _rank_main, args=(fn, tuple(args), nprocs, backend, init_method, timeout, threads,
                          results),
        nprocs=nprocs, join=False, start_method="spawn")
    got, failures = {}, []

    def drain():  # a rank blocks in put() until its result is read
        while not results.empty():
            rank, out = results.get()
            if isinstance(out, _Failure):
                failures.append((rank, out))
            else:
                got[rank] = out

    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.2):  # raises when a rank failed
            drain()
            if time.monotonic() > deadline:
                raise TimeoutError(f"launch_local: {nprocs} ranks still running after "
                                   f"{timeout:.0f} s")
    except ProcessException as exc:
        drain()
        if failures:
            rank, tb = failures[0]
            raise RuntimeError(f"launch_local: rank {rank} of {nprocs} failed:\n{tb}") from exc
        raise
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    drain()
    missing = sorted(set(range(nprocs)) - set(got))
    if missing:
        raise RuntimeError(f"launch_local: ranks {missing} returned no result")
    return [got[r] for r in range(nprocs)]
