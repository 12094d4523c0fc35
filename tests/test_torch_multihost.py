"""The port's bootstrap of several processes
(``lmsf_slam_tpu_torch.parallel.multihost``) on the CPU: the counterpart of
``tests/test_schur.py::test_multihost_helpers_single_process``, and two ranks
started by hand with the ``LMSF_*`` variables (the launch that several hosts
use: one command a process, rank 0's address as the coordinator). Real hosts
do not exist here; two processes on one host over ``127.0.0.1`` take the same
path. Also the local launcher: a rank that fails fails the launch, and a
launch that outlives its time limit is stopped.
"""
import pytest
import torch
import torch.multiprocessing as tmp

from lmsf_slam_tpu_torch.parallel import multihost
from tests import torch_ranks
from tests import torch_threads  # noqa: F401

LAUNCH_VARS = ("LMSF_COORDINATOR", "LMSF_NUM_PROCESSES", "LMSF_PROCESS_ID", "MASTER_ADDR",
               "MASTER_PORT", "RANK", "WORLD_SIZE")


def test_single_process_without_variables(monkeypatch):
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_from_env() is False
    assert multihost.process_info() == (0, 1)
    assert multihost.shard_bounds(100) == (0, 100)
    assert multihost.global_mesh(backend="cpu").size == 1


def test_two_ranks_from_the_lmsf_variables():
    coordinator = multihost.free_tcp_address()[len("tcp://"):]
    results = tmp.get_context("spawn").SimpleQueue()
    tmp.start_processes(torch_ranks.multihost_bootstrap, args=(coordinator, 2, results),
                        nprocs=2, join=True, start_method="spawn")
    got = dict(results.get() for _ in range(2))
    for rank in (0, 1):
        r = got[rank]
        assert r["active"] and r["again"]
        assert r["info"] == (rank, 2)
        assert r["backend"] == "gloo"  # no card here
        assert r["mesh_size"] == 2
    assert got[0]["bounds"] == (0, 50) and got[1]["bounds"] == (50, 100)


def test_a_failing_rank_fails_the_launch(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        multihost.launch_local(torch_ranks.fail_on_rank, 2, args=(1,), backend="gloo",
                               init_method=f"file://{tmp_path / 'store'}", timeout=60.0,
                               threads=1)


def test_a_launch_past_its_time_limit_is_stopped(tmp_path):
    with pytest.raises(TimeoutError):
        multihost.launch_local(torch_ranks.sleep, 2, args=(600,), backend="gloo",
                               init_method=f"file://{tmp_path / 'store'}", timeout=20.0,
                               threads=1)
