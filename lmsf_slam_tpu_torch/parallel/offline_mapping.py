"""Sequence-sharded offline mapping: map a long trajectory across a mesh.

Counterpart of ``lmsf_slam_tpu/parallel/offline_mapping.py``. Each rank
tracks one contiguous chunk of the scans with the port's tracker (no
collective while it tracks), the chunks' final maps and last poses are
all-gathered, and each chunk boundary is stitched by registering the first
scan of chunk c+1 against chunk c's final map (rank c+1 registers stitch c).
The chunk offsets and the global trajectory are then composed on the host in
numpy, and every rank returns the same result.

Wall clock: tracking is parallel over chunks, so an F-frame sequence costs
F/C tracker steps a rank instead of F, plus one stitch registration.

The reference's ``_make_varying`` has no counterpart: it mixes a varying zero
into a replicated pytree to satisfy ``shard_map``'s typing of scan carries,
and here a rank's state is an ordinary tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..common import se3, se3np
from ..common.pointcloud import PointBatch
from ..ops.registration import RegistrationParams, register_edge_surf
from ..tracker.tracker import TrackerConfig, tracker_init, tracker_step
from .distributed import Mesh, allgather


class OfflineMapResult(NamedTuple):
    poses: np.ndarray  # (F, 7) stitched global trajectory
    chunk_poses: np.ndarray  # (C, F/C, 7) per-chunk local trajectories
    stitch_converged: np.ndarray  # (C-1,) bool


def _track_chunk(edge_xyz, edge_mask, surf_xyz, surf_mask, ts, init_motion, config, device):
    """Sequential tracking of one chunk on ``device``; returns (poses (L, 7),
    the final flat maps' xyz and masks, the last pose, the last motion).

    ``init_motion``: (7,) inter-frame motion prior for the chunk's cold start
    (identity when none). A chunk's first scan pair has only a single-scan map
    and no velocity history: in self-similar geometry the registration is
    degenerate along the travel direction, so real deployments seed this from
    IMU or wheel odometry or a coarse pre-pass."""
    state = tracker_init(config, device)._replace(motion=init_motion.to(device))
    poses = []
    for f in range(edge_xyz.shape[0]):
        state, out = tracker_step(state, PointBatch(edge_xyz[f], edge_mask[f]),
                                  PointBatch(surf_xyz[f], surf_mask[f]), ts[f], config)
        poses.append(out.pose)
    return (torch.stack(poses), state.edge_flat.xyz, state.edge_flat.mask,
            state.surf_flat.xyz, state.surf_flat.mask, state.pose, state.motion)


def _compose_chunks(chunk_poses: np.ndarray, stitch: np.ndarray) -> np.ndarray:
    """Global poses (F, 7) from chunk-local trajectories (C, L, 7) and the
    stitch poses (C-1, 7), the pose of scan (c+1, 0) in chunk c's frame.

    O_0 = identity, O_{c+1} = O_c ∘ stitch_c; frame (c, i) is O_c ∘ traj[c, i]
    (a chunk's frame 0 is its identity, and the stitch measured frame (c, 0)
    in chunk c−1's frame). Composed in float64, returned in float32."""
    offsets = [se3np.pose_identity()]
    for s in stitch:
        offsets.append(se3np.pose_compose(offsets[-1], s))
    offsets = np.stack(offsets)  # (C, 7)
    out = se3np.pose_compose(offsets[:, None, :], chunk_poses)
    return out.reshape(-1, 7).astype(np.float32)


def offline_map_sequence(
    mesh: Mesh,
    edge: PointBatch,  # (F, Ne, 3) feature scans (sensor frame)
    surf: PointBatch,  # (F, Ns, 3)
    timestamps,  # (F,)
    config: TrackerConfig,
    stitch_params: RegistrationParams | None = None,
    init_motions=None,  # (C, 7) cold-start motion priors
) -> OfflineMapResult:
    """Track an F-frame sequence in C = mesh size chunks, rank c tracking
    chunk c on its device (F must divide into C chunks)."""
    C = mesh.size
    F = int(edge.xyz.shape[0])
    if F % C:
        raise ValueError(f"offline_map_sequence: {F} frames do not divide into {C} chunks")
    L = F // C
    dev = mesh.device
    c = mesh.rank
    mine = slice(c * L, (c + 1) * L)

    def chunk(x):
        return torch.as_tensor(x[mine], device=dev)

    if init_motions is None:
        init_motion = se3.pose_identity(device=dev)
    else:
        init_motion = torch.as_tensor(init_motions[c], dtype=torch.float32)
    exyz, emask, sxyz, smask = (chunk(a) for a in (edge.xyz, edge.mask, surf.xyz, surf.mask))
    out = _track_chunk(exyz, emask, sxyz, smask, chunk(timestamps), init_motion, config, dev)
    chunk_poses, ef_xyz, ef_mask, sf_xyz, sf_mask, last_pose, last_motion = (
        allgather(x, mesh) for x in out)

    # stitch c: the first scan of chunk c+1 against chunk c's final map,
    # registered by rank c+1 (rank 0 has none and sends an identity)
    if stitch_params is None:
        stitch_params = config.registration._replace(max_corr_dist=2.0, max_iters=16)
    stitch = torch.zeros(8, dtype=torch.float32, device=dev)
    stitch[0] = 1.0
    if c > 0:
        reg = register_edge_surf(
            PointBatch(exyz[0], emask[0]), PointBatch(sxyz[0], smask[0]),
            PointBatch(ef_xyz[c - 1], ef_mask[c - 1]), PointBatch(sf_xyz[c - 1], sf_mask[c - 1]),
            se3.pose_compose(last_pose[c - 1], last_motion[c - 1]), stitch_params)
        stitch = torch.cat([reg.pose, reg.converged.to(torch.float32)[None]])
    stitch = allgather(stitch, mesh)[1:].cpu().numpy()  # (C-1, 8)

    chunk_poses = chunk_poses.cpu().numpy()
    return OfflineMapResult(
        poses=_compose_chunks(chunk_poses, stitch[:, :7]),
        chunk_poses=chunk_poses,
        stitch_converged=stitch[:, 7] > 0.5,
    )
