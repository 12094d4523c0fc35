"""2D occupancy grid mapping (log-odds, inverse sensor model).

Counterpart of ``lmsf_slam_tpu/mapping/occupancy.py``. A scan update samples
every ray at K evenly spaced points (free space) plus its endpoint
(occupied), deduplicates cells per scan with 0/1 marks (a scatter of ones is
order-independent, so the marks equal the reference's scatter-max exactly),
and applies one log-odds update. No Bresenham loops; the grid lives on the
device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..common import se3


class OccupancyConfig(NamedTuple):
    size: int = 512  # cells per side (square grid, centered at origin)
    resolution: float = 0.1  # m / cell
    l_occ: float = 0.85  # log-odds increment for a hit
    l_free: float = -0.4  # log-odds increment for traversed free space
    l_min: float = -4.0
    l_max: float = 4.0
    samples_per_ray: int = 96  # free-space samples along each ray
    z_low: float = 0.1  # points in this z band (map frame) mark obstacles
    z_high: float = 2.0


def occupancy_init(config: OccupancyConfig = OccupancyConfig(), device="cuda") -> torch.Tensor:
    return torch.zeros((config.size, config.size), dtype=torch.float32, device=device)


def _marks(xy, valid, config: OccupancyConfig) -> torch.Tensor:
    """(S·S,) float32 marks: 1 in every cell that a valid, in-bounds point
    of ``xy`` (M,2) falls into, else 0."""
    S = config.size
    c = torch.floor(xy / config.resolution).to(torch.int32) + S // 2
    inb = torch.all((c >= 0) & (c < S), dim=-1)
    c = torch.clamp(c, 0, S - 1).long()
    flat = c[:, 0] * S + c[:, 1]
    mark = torch.zeros(S * S, dtype=torch.float32, device=xy.device)
    # an invalid point writes 0 into a cell, a valid one 1: the maximum, as
    # the reference's scatter-max, whatever the order
    return mark.scatter_reduce(0, flat, (inb & valid).to(torch.float32), reduce="amax")


def occupancy_update(
    grid: torch.Tensor,
    origin_xy: torch.Tensor,  # (2,) sensor position in map frame
    points_xy: torch.Tensor,  # (N,2) hit endpoints in map frame
    mask: torch.Tensor,  # (N,)
    config: OccupancyConfig = OccupancyConfig(),
) -> torch.Tensor:
    """One scan's log-odds update: free along rays, occupied at endpoints.

    Cells are updated AT MOST ONCE per scan per class (dedup by marks),
    matching standard occupancy mapping; occupied beats free for cells
    claimed by both (endpoint cells grazed by neighboring rays).
    """
    S = config.size
    K = config.samples_per_ray
    # free-space samples strictly inside the ray (exclude the endpoint cell)
    t = (torch.arange(K, dtype=torch.float32, device=grid.device) + 0.5) / (K + 1)
    pts = origin_xy[None, None, :] + t[None, :, None] * (
        points_xy[:, None, :] - origin_xy[None, None, :]
    )  # (N,K,2)
    free_mark = _marks(pts.reshape(-1, 2), torch.repeat_interleave(mask, K), config)
    occ_mark = _marks(points_xy, mask, config)
    free_mark = free_mark * (1.0 - occ_mark)  # occupied wins
    grid = grid + (config.l_occ * occ_mark + config.l_free * free_mark).reshape(S, S)
    return torch.clamp(grid, config.l_min, config.l_max)


def occupancy_probability(grid: torch.Tensor) -> torch.Tensor:
    """Log-odds → occupancy probability."""
    return torch.sigmoid(grid)


def keyframe_update(grid, pose, pts, mask, config: OccupancyConfig) -> torch.Tensor:
    """Update ``grid`` with one keyframe: its sensor-frame points ``pts``
    (N,3) at map pose ``pose`` (7,), the points inside the z band marking
    obstacles."""
    w = se3.pose_apply(pose, pts)
    band = (w[:, 2] > config.z_low) & (w[:, 2] < config.z_high)
    return occupancy_update(grid, se3.pose_trans(pose)[:2], w[:, :2], mask & band, config)


def occupancy_from_database(db, config: OccupancyConfig = OccupancyConfig()):
    """Build the synchronized 2D grid from every keyframe in the lifelong
    database at its CURRENT optimized pose (so loop corrections propagate
    into the grid), on the database's device."""
    grid = occupancy_init(config, db.device)
    for i in range(db.n_keyframes):
        pose = db._to_device(db.map_poses[i])
        edge, surf = db.keyframe_clouds(i)
        grid = keyframe_update(
            grid, pose, torch.cat([edge.xyz, surf.xyz]), torch.cat([edge.mask, surf.mask]), config
        )
    return grid
