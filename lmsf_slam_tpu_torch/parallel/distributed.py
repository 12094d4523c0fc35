"""Beyond one device: batched frame registration and the edge-sharded pose-graph solve.

Counterpart of ``lmsf_slam_tpu/parallel/distributed.py`` on
``torch.distributed``. The reference runs one program over a
``jax.sharding.Mesh`` of devices; here every device has a process of its own
(a rank), all ranks run the same program (SPMD), and a :class:`Mesh` names
the process group, this rank's place in it and its device:

- frames are embarrassingly parallel: :func:`register_frames_batched` gives
  each rank a contiguous block of frames and all-gathers the results;
- pose-graph edges are sharded: each Gauss-Newton step runs matrix-free PCG
  where every Hessian-vector product is computed from the rank's edges and
  summed over the mesh with one all-reduce. Vertex state stays replicated
  (poses are V×7 floats), so no all-gather is needed.

One process a device, not one process driving several: every path of the
port is bound by the host (Python launches the kernels), and one thread that
drove several devices would serialise their launches.

A world of one (no process group) is the reference's single-device mesh:
every collective is the identity. Ranks that share a card, or that run on
the CPU, talk through gloo (NCCL refuses two ranks on one card); ranks with
a card each through NCCL (:func:`.multihost.choose_backend`). There is no
fallback to the CPU: a mesh on the card that finds too few cards raises.

On a card the scatters of the solve sum in float64 and the all-reduce adds
those float64 sums, rounded once after it: ``index_add_`` on a card adds in
no fixed order, and a float32 sum would make two runs differ.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from ..backend.pose_graph import (
    PoseGraphParams,
    PoseGraphStats,
    _edge_res_jac,
    _robust_weight,
    edge_residual,
)
from ..common import se3
from ..common.pointcloud import PointBatch
from ..ops.registration import RegistrationParams, RegistrationResult, register_edge_surf


class Mesh(NamedTuple):
    """A 1-D mesh of ranks, as this rank sees it."""

    group: Any  # the process group; None: this process alone (a world of one)
    axis: str
    size: int
    rank: int  # this rank's index in the mesh
    device: torch.device  # this rank's device


def make_mesh(n_devices: int | None = None, axis: str = "graph", backend: str | None = None):
    """A mesh over the first ``n_devices`` ranks of the process group.

    With no process group initialised this is a world of one. ``backend="cpu"``
    puts the mesh on CPU tensors (the group must then be gloo); otherwise each
    rank takes ``cuda:{LOCAL_RANK}``, or ``cuda:{rank % device_count}`` where
    the launcher sets no ``LOCAL_RANK``. Asking for more ranks than the world
    has raises ``ValueError``, as does a mesh on the card without one. With
    fewer ranks than the world, every rank must call this (it makes a new
    group); a rank outside the mesh gets None.
    """
    if backend not in (None, "cpu"):
        raise ValueError(f"make_mesh: backend {backend!r}: None (the card) or 'cpu'")
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: need {n} ranks, the world has {world}")
    group = None
    if initialised:
        group = dist.group.WORLD if n == world else dist.new_group(ranks=list(range(n)))
        if rank >= n:
            return None
    if backend == "cpu":
        if initialised and dist.get_backend() != "gloo":
            raise ValueError(f"make_mesh: CPU tensors need gloo, the group is {dist.get_backend()}")
        device = torch.device("cpu")
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = int(os.environ.get("LOCAL_RANK", rank % max(count, 1)))
        if index >= count:
            raise ValueError(f"make_mesh: rank {rank} needs cuda:{index}, this host has "
                             f"{count} CUDA device(s); pass backend='cpu' for the CPU")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    return Mesh(group, axis, n, rank, device)


def allreduce(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Σ of ``x`` over the mesh (a new tensor; ``x`` itself for a world of one)."""
    if mesh is None or mesh.group is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=mesh.group)
    return y


def allgather(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x``, in rank order, on ``x``'s device.

    gloo gathers CPU tensors only, so a CUDA tensor in a gloo group is staged
    through the host here; NCCL gathers on the card."""
    if mesh is None or mesh.group is None:
        return x[None]
    staged = x.is_cuda and dist.get_backend(mesh.group) == "gloo"
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.stack(parts).to(x.device)


def _reduced_sum(rows_i, rows_j, i_idx, j_idx, V: int, mesh):
    """Σ over the mesh of ``segment_sum(rows_i, i_idx) + segment_sum(rows_j,
    j_idx)`` into V vertex rows: in float64 on a card through the all-reduce,
    rounded once; in the rows' type on the CPU (the reference's order)."""
    acc = torch.float64 if rows_i.is_cuda else rows_i.dtype
    out = rows_i.new_zeros((V,) + rows_i.shape[1:], dtype=acc)
    out.index_add_(0, i_idx, rows_i.to(acc))
    out.index_add_(0, j_idx, rows_j.to(acc))
    return allreduce(out, mesh).to(rows_i.dtype)


# ---------------------------------------------------------------------------
# Data-parallel frontend: batched registration sharded over frames
# ---------------------------------------------------------------------------


def _frame(pb: PointBatch, f: int, device) -> PointBatch:
    return PointBatch(*(torch.as_tensor(a[f], device=device) for a in (pb.xyz, pb.mask, pb.attr)))


def register_frames_batched(
    src_edge: PointBatch,  # leading frame axis (F, N, 3) / (F, N)
    src_surf: PointBatch,
    map_edge: PointBatch,  # (F, M, 3) per-frame maps (e.g. previous scans)
    map_surf: PointBatch,
    init_poses,  # (F, 7)
    mesh: Mesh | None = None,
    params: RegistrationParams = RegistrationParams(),
) -> RegistrationResult:
    """Register F frames; each rank registers its contiguous F/size frames on
    its device (``register_edge_surf`` a frame: the k-NN and projector kernels
    on a card) and every rank returns all F results, stacked along a leading
    frame axis. F must be a multiple of the mesh size. Without a mesh all F
    run on the device of ``init_poses``."""
    init = torch.as_tensor(init_poses)
    F = int(init.shape[0])
    n = 1 if mesh is None else mesh.size
    if F % n:
        raise ValueError(f"register_frames_batched: {F} frames do not divide over {n} ranks")
    dev = init.device if mesh is None else mesh.device
    init = init.to(dev)
    per = F // n
    lo = 0 if mesh is None else mesh.rank * per
    out = [register_edge_surf(_frame(src_edge, f, dev), _frame(src_surf, f, dev),
                              _frame(map_edge, f, dev), _frame(map_surf, f, dev), init[f], params)
           for f in range(lo, lo + per)]
    fields = (torch.stack(list(col)) for col in zip(*out))  # (per, ...) a field
    return RegistrationResult(*(allgather(f, mesh).reshape((F,) + f.shape[1:]) for f in fields))


# ---------------------------------------------------------------------------
# Distributed pose-graph Gauss-Newton (edges sharded, all-reduce)
# ---------------------------------------------------------------------------


def _gn_solve_replicated(poses, free, i_idx, j_idx, edges_z, edges_sqrtw, emask,
                         params: PoseGraphParams, mesh: Mesh | None):
    """GN + block-Jacobi PCG where the edge arrays are this rank's shard and
    every edge reduction is followed by an all-reduce over the mesh (the
    identity for a world of one). Poses and ``free`` are replicated, and so is
    the result; the GN loop reads its ``done`` flag once an iteration, where
    the reference's fixed-length scan freezes the iterations after it."""
    V = poses.shape[0]
    dev = poses.device
    eye6 = torch.eye(6, dtype=poses.dtype, device=dev)

    def chi2_of(p):
        r = edge_residual(p[i_idx], p[j_idx], edges_z) * edges_sqrtw
        return allreduce(torch.sum(torch.where(emask, torch.sum(r * r, -1), 0.0)), mesh)

    def gn_step(p):
        r, Ji, Jj = _edge_res_jac(p[i_idx], p[j_idx], edges_z)
        r = r * edges_sqrtw
        Ji = Ji * edges_sqrtw[:, :, None]
        Jj = Jj * edges_sqrtw[:, :, None]
        r2 = torch.sum(r * r, dim=-1)
        w = _robust_weight(r2, params.kernel, params.kernel_delta) * emask

        def matvec(x):
            y = torch.einsum("eab,eb->ea", Ji, x[i_idx]) + torch.einsum("eab,eb->ea", Jj, x[j_idx])
            y = y * w[:, None]
            out = _reduced_sum(torch.einsum("eab,ea->eb", Ji, y),
                               torch.einsum("eab,ea->eb", Jj, y), i_idx, j_idx, V, mesh)
            return torch.where(free[:, None], out + params.damping * x, 0.0)

        wr = r * w[:, None]
        g = _reduced_sum(torch.einsum("eab,ea->eb", Ji, wr), torch.einsum("eab,ea->eb", Jj, wr),
                         i_idx, j_idx, V, mesh)
        g = torch.where(free[:, None], g, 0.0)

        M = _reduced_sum(torch.einsum("eab,eac,e->ebc", Ji, Ji, w),
                         torch.einsum("eab,eac,e->ebc", Jj, Jj, w), i_idx, j_idx, V, mesh)
        # inv_ex: no check on the host; a singular block gives NaN, as XLA's inv
        Minv, info = torch.linalg.inv_ex(M + (params.damping + 1e-6) * eye6)
        Minv = torch.where((info == 0)[:, None, None], Minv, torch.nan)

        def precond(x):
            return torch.where(free[:, None], torch.einsum("vab,vb->va", Minv, x), 0.0)

        # PCG from x0 = 0 for a fixed number of iterations (the reference's scan)
        rr = -g
        x = torch.zeros_like(rr)
        zz = precond(rr)
        pp = zz
        rz = torch.sum(rr * zz)
        for _ in range(params.pcg_iters):
            Ap = matvec(pp)
            pAp = torch.sum(pp * Ap)
            alpha = rz / torch.where(torch.abs(pAp) > 1e-20, pAp, 1e-20)
            x = x + alpha * pp
            rr = rr - alpha * Ap
            zz = precond(rr)
            rz_new = torch.sum(rr * zz)
            beta = rz_new / torch.where(torch.abs(rz) > 1e-20, rz, 1e-20)
            pp = zz + beta * pp
            rz = rz_new

        new_p = torch.where(free[:, None], se3.pose_retract(p, x), p)
        dx_norm = torch.sqrt(torch.sum(x * x) / torch.clamp(torch.sum(free), min=1))
        return new_p, dx_norm < params.converged_dx

    chi2_0 = chi2_of(poses)
    p = poses
    iters = 0
    while iters < params.gn_iters:
        p, small = gn_step(p)
        iters += 1
        # every input of ``small`` is replicated bit for bit, so every rank
        # leaves the loop at the same iteration
        if bool(small):
            break
    return p, PoseGraphStats(chi2_0, chi2_of(p), torch.tensor(iters, dtype=torch.int32, device=dev))


def optimize_pose_graph_sharded(
    poses,  # (V, 7) replicated
    vmask,
    edges_ij,  # (E, 2); padded here to a multiple of the mesh size
    edges_z,
    edges_sqrtw,
    emask,
    mesh: Mesh,
    fixed=None,
    params: PoseGraphParams = PoseGraphParams(),
):
    """Distributed GN/PCG pose-graph solve: edges sharded over the mesh (rank
    r holds ``[r·E/n, (r+1)·E/n)`` of the padded edges), vertices replicated,
    one all-reduce per edge reduction. Arguments may be tensors or numpy; they
    are moved to the mesh's device, in the type of ``poses``. Returns
    (replicated poses, PoseGraphStats)."""
    dev = mesh.device
    poses = torch.as_tensor(poses, device=dev)
    dt = poses.dtype
    V = poses.shape[0]
    vmask = torch.as_tensor(vmask, dtype=torch.bool, device=dev)
    if fixed is None:
        fixed = torch.zeros(V, dtype=torch.bool, device=dev)
        fixed[0] = True
    free = vmask & ~torch.as_tensor(fixed, dtype=torch.bool, device=dev)
    eij = torch.as_tensor(edges_ij, device=dev).long()
    ez = torch.as_tensor(edges_z, device=dev).to(dt)
    esw = torch.as_tensor(edges_sqrtw, device=dev).to(dt)
    em = torch.as_tensor(emask, dtype=torch.bool, device=dev)
    E = eij.shape[0]
    pad = (-E) % mesh.size
    if pad:
        pad_z = torch.zeros((pad, 7), dtype=dt, device=dev)
        pad_z[:, 0] = 1.0  # identity quaternions on the padding
        eij = torch.cat([eij, eij.new_zeros((pad, 2))])
        ez = torch.cat([ez, pad_z])
        esw = torch.cat([esw, esw.new_zeros((pad, 6))])
        em = torch.cat([em, em.new_zeros(pad)])
    per = (E + pad) // mesh.size
    s = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return _gn_solve_replicated(poses, free, eij[s, 0], eij[s, 1], ez[s], esw[s], em[s],
                                params, mesh)


# ---------------------------------------------------------------------------
# Full multi-device SLAM step (frontend + backend)
# ---------------------------------------------------------------------------


def slam_training_step(mesh: Mesh, frames, graph, reg_params=None, pg_params=None):
    """One sharded SLAM iteration: frame registration over the mesh plus the
    edge-sharded pose-graph solve.

    ``frames``: dict with PointBatches ``src_edge, src_surf, map_edge,
    map_surf`` (leading frame axis) and ``init_poses`` (F, 7). ``graph``:
    dict with ``poses, vmask, edges_ij, edges_z, edges_sqrtw, emask``.
    Returns (RegistrationResult of every frame, optimized poses, stats).
    """
    reg_params = reg_params or RegistrationParams(max_iters=2)
    pg_params = pg_params or PoseGraphParams(gn_iters=2, pcg_iters=8)
    results = register_frames_batched(
        frames["src_edge"], frames["src_surf"], frames["map_edge"], frames["map_surf"],
        frames["init_poses"], mesh, reg_params)
    poses, stats = optimize_pose_graph_sharded(
        graph["poses"], graph["vmask"], graph["edges_ij"], graph["edges_z"],
        graph["edges_sqrtw"], graph["emask"], mesh, params=pg_params)
    return results, poses, stats
