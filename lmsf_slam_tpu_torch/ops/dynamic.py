"""Dynamic-object filtering: free-space carving + unsupported-point gating.

Counterpart of ``lmsf_slam_tpu/ops/dynamic.py``, standard visibility
reasoning over the scan's range image:

- :func:`carve_dynamic` — a MAP point is dynamic if the current scan's beam
  through its (ring, azimuth) cell measured a LONGER range: the beam passed
  through where the point used to be, so the point has moved away. Map points
  are projected into the scan's range image (a gather of the measured range
  per map point) and compared; no scatter, no host read.
- :func:`unsupported_mask` — a SCAN point entering an already-mapped region
  with no map support within ``dist_thresh`` is a candidate mover (used to
  keep transient objects out of the map until they persist). It goes through
  ``nn1``, hence the k-NN kernels on a card.
"""
from __future__ import annotations

import math

import torch

from ..common import se3
from ..common.pointcloud import PointBatch
from . import neighbors
from .features import ScanGrid


def carve_dynamic(
    grid: ScanGrid,
    map_pb: PointBatch,
    sensor_pose: torch.Tensor,  # (7,) pose of the scan's sensor (map frame)
    elev_min=-0.26,
    elev_max=0.26,
    margin: float = 0.3,  # m: beam must overshoot the point by this much
    min_range: float = 1.0,
    rel_margin: float = 0.05,  # + this fraction of range (quantization slack)
    z_min=0.3,  # map-frame ground exclusion band
) -> torch.Tensor:
    """(M,) keep-mask over ``map_pb``: False = contradicted by free space.

    ``elev_min``, ``elev_max`` and ``z_min`` may be floats or 0-d tensors on
    the grid's device (the tracker hands over the scan's own limits without
    reading them back).

    Carving is deliberately conservative (false positives delete real map
    structure):

    - **ground exclusion** (``z_min``): near-ground points are never carved —
      rays graze the ground, so a ±half-ring elevation quantization error
      moves the expected ground range by meters and any absolute test
      false-fires;
    - **support test**: if ANY beam in the point's 3×3 (ring, azimuth)
      neighborhood measured ≈ the point's range, something is still there
      (protects thin pillars the quantized center column misses);
    - **range-adaptive margin**: overshoot must exceed
      ``margin + rel_margin·range`` (quantization error grows with range).
    """
    R, W = grid.rng.shape
    # map points in the sensor frame
    local = se3.pose_apply(se3.pose_inverse(sensor_pose), map_pb.xyz)
    rng = torch.linalg.vector_norm(local, dim=-1)
    horiz = torch.linalg.vector_norm(local[:, :2], dim=-1)
    elev = torch.atan2(local[:, 2], torch.clamp(horiz, min=1e-6))
    az = torch.atan2(local[:, 1], local[:, 0])
    # round half to even and floor, both as in the reference
    ring = torch.round((elev - elev_min) / (elev_max - elev_min) * (R - 1))
    col = torch.floor((az + math.pi) / (2 * math.pi) * W)
    in_fov = (
        (ring >= 0) & (ring <= R - 1) & (rng > min_range)
        & map_pb.mask
        & (map_pb.xyz[:, 2] > z_min)
    )
    # clip before the gathers (the reference clips too; a non-finite ring of
    # a degenerate elevation span is clipped like any other)
    ring_i = torch.clamp(torch.nan_to_num(ring, nan=0.0), 0, R - 1).long()
    col_i = torch.clamp(torch.nan_to_num(col, nan=0.0), 0, W - 1).long()
    tol = margin + rel_margin * rng
    # support tolerance is tighter than the carve tolerance: a beam "sees"
    # the point only if it measured essentially the point's range (sensor
    # noise + on-surface quantization shift), whereas carving must clear the
    # full cross-ring aliasing budget
    sup_tol = margin + 0.02 * rng
    supported = torch.zeros_like(map_pb.mask)
    for dr in (-1, 0, 1):
        r_i = torch.clamp(ring_i + dr, 0, R - 1)
        for dc in (-1, 0, 1):
            c_i = (col_i + dc) % W  # azimuth wraps (floor-mod)
            v = grid.mask[r_i, c_i]
            m = grid.rng[r_i, c_i]
            supported = supported | (v & (torch.abs(m - rng) <= sup_tol))
    measured = grid.rng[ring_i, col_i]
    cell_valid = grid.mask[ring_i, col_i]
    seen_through = in_fov & cell_valid & ~supported & (measured > rng + tol)
    return ~seen_through


def unsupported_mask(
    scan_pb: PointBatch,
    map_pb: PointBatch,
    pose: torch.Tensor,  # (7,) scan pose (map frame)
    dist_thresh: float = 0.5,
) -> torch.Tensor:
    """(N,) True where a scan point has NO map support within dist_thresh —
    candidate dynamic points (or genuinely new structure; persistence over
    frames disambiguates, which the caller tracks)."""
    world = se3.pose_apply(pose, scan_pb.xyz)
    d, _ = neighbors.nn1(world, scan_pb.mask, map_pb.xyz, map_pb.mask)
    return scan_pb.mask & (d > dist_thresh * dist_thresh)
