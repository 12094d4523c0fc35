"""The tracker's registration map, worked out again: the scans its ring of
local-map slots holds (the insertion rule run over the returned poses from
the system's first frame), their features moved by those poses, the union
voxel-downsampled, and, where the configuration's probation is on, carved by
the free space of the scan that last rebuilt it. Plain PyTorch, in the dtype
of the inputs.

The voxel grid is the system's: integer cells on a 1024³ lattice whose
origin is the cloud's centroid snapped to the voxel size, the mean of each
occupied cell, cells kept in ascending key order up to the capacity. The
carving is the system's free-space test (a beam of the scan measured more
than the point's range plus a margin, with no beam of its 3×3 neighbourhood
near the point's range, away from the ground band).
"""
from __future__ import annotations

import math

import torch

from . import se3

G = 1024


def inserts(last_pose, last_time, pose, stamp, rule) -> bool:
    """Whether a frame at ``pose`` and ``stamp`` enters the local map after
    the last insertion at ``last_pose`` and ``last_time`` (motion or time)."""
    d = se3.between(last_pose, pose)
    dx = float(torch.linalg.vector_norm(d[4:]))
    dr = float(torch.linalg.vector_norm(se3.so3_log(d[:4])))
    return dx > rule["trans"] or dr > rule["rot"] or stamp - last_time > rule["dt"]


def insertions(odometry: dict, stamp_of, rule) -> list:
    """Frames inserted into the local map, in order, from the system's first
    frame: the first always, each later one by :func:`inserts`."""
    out, last = [], None
    for frame in sorted(odometry):
        pose = torch.as_tensor(odometry[frame], dtype=torch.float64)
        if last is None or inserts(last[0], last[1], pose, stamp_of(frame), rule):
            out.append(frame)
            last = (pose, stamp_of(frame))
    return out


def voxel_downsample(xyz, mask, size: float, capacity: int):
    """(means, mask) of the occupied cells, ascending key, at most
    ``capacity``."""
    pts = xyz[mask]
    if pts.shape[0] == 0:
        return xyz[:0], mask[:0]
    origin = torch.floor(pts.mean(0) / size) * size
    ci = (torch.floor((pts - origin) / size).long() + G // 2).clamp(0, G - 1)
    key = (ci[:, 0] * G + ci[:, 1]) * G + ci[:, 2]
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], 3, dtype=pts.dtype, device=pts.device).index_add_(0, inv, pts)
    counts = torch.bincount(inv, minlength=uniq.shape[0]).to(pts.dtype)
    means = (sums / counts[:, None])[:capacity]
    return means, torch.ones(means.shape[0], dtype=torch.bool, device=means.device)


def carve_keep(grid, xyz, mask, pose, margin=0.3, min_range=1.0, rel_margin=0.05, z_min=0.3):
    """Keep-mask of map points ``xyz`` (map frame) against the free space of
    a scan's range image ``grid`` = (xyz (R,W,3), range (R,W), mask (R,W))
    taken at ``pose``; the elevation limits are the scan's own."""
    g_xyz, g_rng, g_mask = grid
    R, W = g_rng.shape
    g_elev = torch.atan2(g_xyz[..., 2], torch.linalg.vector_norm(g_xyz[..., :2], dim=-1) + 1e-9)
    lo = torch.min(torch.where(g_mask, g_elev, math.inf))
    hi = torch.max(torch.where(g_mask, g_elev, -math.inf))
    local = se3.apply(se3.inverse(pose), xyz)
    rng = torch.linalg.vector_norm(local, dim=-1)
    horiz = torch.linalg.vector_norm(local[:, :2], dim=-1)
    elev = torch.atan2(local[:, 2], horiz.clamp(min=1e-6))
    az = torch.atan2(local[:, 1], local[:, 0])
    ring = torch.round((elev - lo) / (hi - lo) * (R - 1))
    col = torch.floor((az + math.pi) / (2 * math.pi) * W)
    in_fov = (ring >= 0) & (ring <= R - 1) & (rng > min_range) & mask & (xyz[:, 2] > z_min)
    ring_i = torch.nan_to_num(ring, nan=0.0).clamp(0, R - 1).long()
    col_i = torch.nan_to_num(col, nan=0.0).clamp(0, W - 1).long()
    supported = torch.zeros_like(mask)
    for dr in (-1, 0, 1):
        r_i = (ring_i + dr).clamp(0, R - 1)
        for dc in (-1, 0, 1):
            c_i = (col_i + dc) % W
            supported |= g_mask[r_i, c_i] & (torch.abs(g_rng[r_i, c_i] - rng) <= margin + 0.02 * rng)
    seen_through = (in_fov & g_mask[ring_i, col_i] & ~supported
                    & (g_rng[ring_i, col_i] > rng + margin + rel_margin * rng))
    return ~seen_through
