"""Functions that the port's multi-rank tests run in each rank.

``lmsf_slam_tpu_torch.parallel.multihost.launch_local`` starts the ranks with
the ``spawn`` method, so every function here is imported by name in a fresh
process: this module imports neither JAX nor the reference package, and the
tests compute the reference's results in their own process. Each function
builds its mesh on the CPU (gloo) and returns numpy arrays and plain values.
"""
import numpy as np
import torch

from lmsf_slam_tpu_torch.backend.pose_graph import PoseGraphParams
from lmsf_slam_tpu_torch.parallel.distributed import allreduce
from lmsf_slam_tpu_torch.parallel import (
    make_mesh,
    multihost,
    optimize_pose_graph_schur,
    optimize_pose_graph_sharded,
    register_frames_batched,
    slam_training_step,
)


def _stats(stats):
    return {"chi2_initial": float(stats.chi2_initial), "chi2_final": float(stats.chi2_final),
            "iterations": int(stats.iterations)}


def sharded_solves(cases):
    """{name: (poses, stats)} of ``optimize_pose_graph_sharded`` on a CPU mesh
    over the whole world for each ``(name, graph, params)``; whether
    ``make_mesh`` beyond the world raised ``ValueError``; and (size, rank) of
    this rank in a mesh over the first two ranks (None outside it)."""
    mesh = make_mesh(backend="cpu")
    out = {}
    for name, graph, params in cases:
        poses, stats = optimize_pose_graph_sharded(
            torch.as_tensor(graph["poses"]), graph["vmask"], graph["edges_ij"], graph["edges_z"],
            graph["edges_sqrtw"], graph["emask"], mesh, params=PoseGraphParams(**params))
        out[name] = (poses.numpy(), _stats(stats))
    try:
        make_mesh(mesh.size + 1, backend="cpu")
        out["beyond_world_raised"] = False
    except ValueError:
        out["beyond_world_raised"] = True
    sub = make_mesh(2, backend="cpu")
    out["sub_mesh"] = None if sub is None else (sub.size, sub.rank)
    if sub is not None:  # the sub-mesh's collectives reach its two ranks only
        out["sub_sum"] = float(allreduce(torch.ones(()), sub))
    return out


def schur_solves(cases):
    """{name: (poses, stats)} of ``optimize_pose_graph_schur`` on a CPU mesh
    for each ``(name, kwargs, params)``."""
    mesh = make_mesh(backend="cpu")
    out = {}
    for name, kw, params in cases:
        kw = dict(kw)
        poses = torch.as_tensor(kw.pop("poses"))
        p, stats = optimize_pose_graph_schur(poses, **kw, mesh=mesh,
                                             params=PoseGraphParams(**params))
        out[name] = (p.numpy(), _stats(stats))
    return out


def batched_registration(frames, graph):
    """``register_frames_batched`` on a CPU mesh, then ``slam_training_step``
    with its default budgets on ``graph``; numpy fields of both."""
    from lmsf_slam_tpu_torch.common.pointcloud import PointBatch

    mesh = make_mesh(backend="cpu")

    def pb(name):
        return PointBatch(*(torch.as_tensor(a) for a in frames[name]))

    res = register_frames_batched(pb("src_edge"), pb("src_surf"), pb("map_edge"), pb("map_surf"),
                                  torch.as_tensor(frames["init_poses"]), mesh)
    out = {"batched": {k: v.numpy() for k, v in res._asdict().items()}}
    step = {k: pb(k) for k in ("src_edge", "src_surf", "map_edge", "map_surf")}
    step["init_poses"] = torch.as_tensor(frames["init_poses"])
    results, poses, stats = slam_training_step(mesh, step, graph)
    out["step"] = ({k: v.numpy() for k, v in results._asdict().items()}, poses.numpy(),
                   _stats(stats))
    return out


def dryrun(n_devices):
    """``entry.dryrun_multichip`` on the CPU in every rank."""
    from lmsf_slam_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(n_devices, device="cpu")
    return True


def offline_map(edge, surf, stamps, config):
    """``offline_map_sequence`` on a CPU mesh over the whole world: its
    result as numpy."""
    from lmsf_slam_tpu_torch.common.pointcloud import PointBatch
    from lmsf_slam_tpu_torch.parallel.offline_mapping import offline_map_sequence

    mesh = make_mesh(axis="data", backend="cpu")
    res = offline_map_sequence(mesh, PointBatch(*(torch.as_tensor(a) for a in edge)),
                               PointBatch(*(torch.as_tensor(a) for a in surf)),
                               torch.as_tensor(stamps), config)
    return {k: np.asarray(v) for k, v in res._asdict().items()}


def multihost_bootstrap(rank, coordinator, world, results):
    """Rank ``rank`` of ``world`` started by hand (no group yet) with the
    ``LMSF_*`` variables: what the bootstrap gives it, put on ``results``."""
    import os

    import torch.distributed as dist

    os.environ.update({"LMSF_COORDINATOR": coordinator, "LMSF_NUM_PROCESSES": str(world),
                       "LMSF_PROCESS_ID": str(rank)})
    torch.set_num_threads(1)
    active = multihost.initialize_from_env(timeout=60.0)
    try:
        results.put((rank, {"active": active, "again": multihost.initialize_from_env(),
                            "info": multihost.process_info(), "backend": dist.get_backend(),
                            "mesh_size": multihost.global_mesh(backend="cpu").size,
                            "bounds": multihost.shard_bounds(100)}))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def fail_on_rank(bad):
    """Rank ``bad`` raises; the others wait for it at a barrier."""
    import torch.distributed as dist

    if dist.get_rank() == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    dist.barrier()
    return True


def sleep(seconds):
    import time

    time.sleep(seconds)
    return True
