"""Synthetic structured worlds and smooth trajectories.

Counterpart of ``lmsf_slam_tpu/datasets/synthetic.py``: a world of planes
(ground + walls) and vertical pillars (line features), a smooth trajectory
generator, and a scan simulator that samples sensor-frame edge/surf point
sets with noise.

Randomness is explicit, as in :mod:`.simulator`: :func:`make_world` and
:func:`scan_at` draw from a ``numpy.random.Generator`` (the reference draws
from a JAX key; the two give different numbers from the same seed, while the
structure — pillar grid, planes, the visible set of a pose — is the same).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..common import se3
from ..common.pointcloud import PointBatch


class SyntheticWorld(NamedTuple):
    edge_pts: torch.Tensor  # (Ne, 3) points on vertical lines (pillars)
    surf_pts: torch.Tensor  # (Ns, 3) points on planes (ground + walls)


def make_world(
    rng: np.random.Generator,
    extent: float = 40.0,
    n_pillars: int = 60,
    pts_per_pillar: int = 64,
    n_ground: int = 8000,
    n_wall: int = 4000,
    height: float = 4.0,
    device="cuda",
) -> SyntheticWorld:
    """A courtyard: ground plane, 4 boundary walls, random vertical pillars."""
    f32 = np.float32
    # pillars: vertical lines at random xy, sampled densely in z
    pxy = rng.uniform(-extent, extent, (n_pillars, 2)).astype(f32)
    z = np.linspace(0.0, height, pts_per_pillar, dtype=f32)
    edge = np.concatenate([np.repeat(pxy, pts_per_pillar, axis=0),
                           np.tile(z, n_pillars)[:, None]], axis=1)
    # ground plane
    gxy = rng.uniform(-extent, extent, (n_ground, 2)).astype(f32)
    ground = np.concatenate([gxy, np.zeros((n_ground, 1), f32)], axis=1)
    # 4 walls at ±extent
    nw = n_wall // 4
    wt = rng.uniform(-extent, extent, nw * 4).astype(f32)
    wz = rng.uniform(0.0, height, nw * 4).astype(f32)
    e = f32(extent)
    walls = np.stack([
        np.concatenate([wt[:nw], wt[nw:2 * nw], np.full(nw, e), np.full(nw, -e)]),
        np.concatenate([np.full(nw, e), np.full(nw, -e), wt[2 * nw:3 * nw], wt[3 * nw:]]),
        wz,
    ], axis=1)
    as_t = dict(dtype=torch.float32, device=device)
    return SyntheticWorld(edge_pts=torch.as_tensor(edge, **as_t),
                          surf_pts=torch.as_tensor(np.concatenate([ground, walls]), **as_t))


def make_trajectory(n_frames: int, radius: float = 15.0, loop: bool = True, device="cuda"):
    """Smooth planar arc/loop of poses (yaw follows heading). Returns (n,7)."""
    f32 = dict(dtype=torch.float32, device=device)
    end = 2 * math.pi if loop else math.pi
    theta = torch.linspace(0.0, end, n_frames, **f32)
    x = radius * torch.cos(theta)
    y = radius * torch.sin(theta)
    zpos = 0.5 + 0.2 * torch.sin(3 * theta)
    yaw = theta + math.pi / 2  # tangent heading
    zero = torch.zeros_like(yaw)
    q = torch.stack([torch.cos(yaw / 2), zero, zero, torch.sin(yaw / 2)], dim=-1)
    t = torch.stack([x, y, zpos], dim=-1)
    return se3.make_pose(q, t)


def scan_at(
    world: SyntheticWorld,
    pose: torch.Tensor,
    rng: np.random.Generator,
    n_edge: int = 512,
    n_surf: int = 2048,
    max_range: float = 35.0,
    noise: float = 0.02,
) -> tuple[PointBatch, PointBatch]:
    """Simulate one scan: sample world points within range of ``pose``,
    express them in the sensor frame, add Gaussian noise. Returns (edge,
    surf) PointBatches with static capacities (n_edge, n_surf), on the
    world's device."""
    pose = torch.as_tensor(pose, dtype=torch.float32, device=world.edge_pts.device)
    inv = se3.pose_inverse(pose)

    def sample(pts, n):
        local = se3.pose_apply(inv, pts)
        r = torch.linalg.vector_norm(local, dim=-1)
        visible = (r < max_range) & (r > 1.0)
        # importance sample visible points (gumbel-top-k over the mask)
        u = torch.as_tensor(rng.random(pts.shape[0]), dtype=torch.float32, device=pts.device)
        gumbel = -torch.log(-torch.log(u + 1e-12))
        score = torch.where(visible, gumbel, -torch.inf)
        idx = torch.topk(score, n).indices
        sel = local[idx]
        ok = visible[idx]
        eps = torch.as_tensor(rng.standard_normal(sel.shape), dtype=torch.float32,
                              device=pts.device)
        sel = sel + noise * eps
        return PointBatch(torch.where(ok[:, None], sel, 0.0), ok)

    return sample(world.edge_pts, n_edge), sample(world.surf_pts, n_surf)
