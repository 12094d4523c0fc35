"""Ray-cast LiDAR simulator: structured, organized scans of a geometric world.

Counterpart of ``lmsf_slam_tpu/datasets/simulator.py``: one range return per
(ring, azimuth) beam, by closed-form ray casting against a ground plane,
axis-aligned boxes and vertical cylinders, all rays of a scan at once.

Randomness is explicit: :func:`make_sim_world` draws from a
``numpy.random.Generator`` and returns numpy arrays, and
:func:`simulate_scan` takes its range noise as an array of standard normals
(or a generator to draw them from); so does :func:`simulate_scan_moving`,
the motion-blurred sweep of a moving platform. So a test can give this
simulator and the reference the same world and the same noise.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..common import se3
from ..common.pointcloud import PointBatch

_BIG = 1e9


class SimWorld(NamedTuple):
    boxes_min: np.ndarray  # (B, 3) float32 axis-aligned box min corners
    boxes_max: np.ndarray  # (B, 3)
    cylinders: np.ndarray  # (C, 4) [cx, cy, radius, height] vertical cylinders
    ground_z: float  # ground plane height


def make_sim_world(
    rng: np.random.Generator,
    extent: float = 30.0,
    n_boxes: int = 12,
    n_cylinders: int = 24,
    box_size: tuple = (2.0, 6.0),
    box_height: tuple = (2.0, 6.0),
    cyl_radius: tuple = (0.15, 0.5),
    cyl_height: float = 5.0,
    clear_radius: float = 4.0,
) -> SimWorld:
    """A random 'campus': ground plane + boxes + pillars inside ±extent.

    ``clear_radius`` keeps a disc at the origin free of obstacles so
    trajectories through the middle don't start inside geometry.
    """

    def place(n, margin):
        xy = rng.uniform(-extent, extent, (n, 2)).astype(np.float32)
        # push anything inside the clear disc radially outward
        r = np.linalg.norm(xy, axis=1, keepdims=True)
        lo = clear_radius + margin
        scale = np.where(r < lo, lo / np.maximum(r, 1e-3), 1.0)
        return (xy * scale).astype(np.float32)

    bxy = place(n_boxes, margin=4.0)
    bwh = rng.uniform(box_size[0], box_size[1], (n_boxes, 2)).astype(np.float32)
    bh = rng.uniform(box_height[0], box_height[1], (n_boxes, 1)).astype(np.float32)
    boxes_min = np.concatenate([bxy - bwh / 2, np.zeros((n_boxes, 1), np.float32)], axis=1)
    boxes_max = np.concatenate([bxy + bwh / 2, bh], axis=1)

    cxy = place(n_cylinders, margin=1.0)
    cr = rng.uniform(cyl_radius[0], cyl_radius[1], (n_cylinders, 1)).astype(np.float32)
    cylinders = np.concatenate(
        [cxy, cr, np.full((n_cylinders, 1), cyl_height, np.float32)], axis=1
    )
    return SimWorld(boxes_min, boxes_max, cylinders, 0.0)


def _ray_ground(o, d, ground_z):
    """t of each ray's ground intersection (or _BIG). d (M,3); o (3,), one
    origin for every ray, or (M,3), one a ray."""
    dz = d[:, 2]
    ok = torch.abs(dz) > 1e-9
    t = (ground_z - o[..., 2]) / torch.where(ok, dz, 1e-9)
    return torch.where(ok & (t > 0), t, _BIG)


def _ray_boxes(o, d, bmin, bmax):
    """Min positive t over all boxes (slab test), or _BIG."""
    if bmin.shape[0] == 0:
        return torch.full_like(d[:, 0], _BIG)
    o = o.reshape(-1, 1, 3)  # (1 | M, 1, 3)
    inv = 1.0 / torch.where(torch.abs(d) > 1e-9, d, 1e-9)  # (M,3)
    t1 = (bmin[None] - o) * inv[:, None, :]  # (M,B,3)
    t2 = (bmax[None] - o) * inv[:, None, :]
    tnear = torch.amax(torch.minimum(t1, t2), dim=2)
    tfar = torch.amin(torch.maximum(t1, t2), dim=2)
    hit = (tnear <= tfar) & (tfar > 0) & (tnear > 0)
    return torch.amin(torch.where(hit, tnear, _BIG), dim=1)


def _ray_cylinders(o, d, cyl):
    """Min positive t over all vertical cylinders, or _BIG."""
    if cyl.shape[0] == 0:
        return torch.full_like(d[:, 0], _BIG)
    cx, cy, r, h = cyl[:, 0], cyl[:, 1], cyl[:, 2], cyl[:, 3]
    o = o.reshape(-1, 3)  # (1 | M, 3)
    ox, oy = o[:, 0:1] - cx, o[:, 1:2] - cy  # (1 | M, C)
    dx, dy = d[:, 0:1], d[:, 1:2]  # (M,1)
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)  # (M,C)
    c = ox * ox + oy * oy - r * r
    a = torch.clamp(a, min=1e-9)
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / (2 * a)
    z = o[:, 2:3] + t * d[:, 2:3]
    hit = (disc > 0) & (t > 0) & (z > 0) & (z < h)
    return torch.amin(torch.where(hit, t, _BIG), dim=1)


def simulate_scan(
    world: SimWorld,
    pose,
    noise_normals,
    rings: int = 16,
    width: int = 900,
    elev_min: float = -0.26,  # ≈ VLP-16 −15°
    elev_max: float = 0.26,
    max_range: float = 50.0,
    min_range: float = 1.0,
    noise: float = 0.01,
    device="cuda",
) -> PointBatch:
    """One organized scan from ``pose`` ((7,) odom pose). Returns a
    (rings·width,) PointBatch in the SENSOR frame, row-major by (ring,
    azimuth), with a 1-dim attr = azimuth-derived relative time in [0, 1).

    ``noise_normals``: (rings·width,) standard normals scaled by ``noise``
    into the range noise, or a ``numpy.random.Generator`` to draw them from.
    """
    if isinstance(noise_normals, np.random.Generator):
        noise_normals = noise_normals.standard_normal(rings * width).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    pose = torch.as_tensor(pose, **f32)
    elev = torch.linspace(elev_min, elev_max, rings, **f32)
    az = -math.pi + (torch.arange(width, **f32) + 0.5) * (2 * math.pi / width)
    ce, se_ = torch.cos(elev), torch.sin(elev)
    ca, sa = torch.cos(az), torch.sin(az)
    # local ray directions (R, W, 3)
    d_local = torch.stack(
        [
            ce[:, None] * ca[None, :],
            ce[:, None] * sa[None, :],
            se_[:, None].expand(rings, width),
        ],
        dim=-1,
    ).reshape(-1, 3)

    Rm = se3.quat_to_matrix(se3.pose_quat(pose))
    o = se3.pose_trans(pose)
    d_world = d_local @ Rm.T

    t = _ray_ground(o, d_world, world.ground_z)
    t = torch.minimum(t, _ray_boxes(
        o, d_world, torch.as_tensor(world.boxes_min, **f32),
        torch.as_tensor(world.boxes_max, **f32)))
    t = torch.minimum(t, _ray_cylinders(o, d_world, torch.as_tensor(world.cylinders, **f32)))
    t = t + noise * torch.as_tensor(noise_normals, **f32).reshape(t.shape)
    ok = (t > min_range) & (t < max_range)
    pts = torch.where(ok[:, None], t[:, None] * d_local, 0.0)
    rel_time = ((torch.arange(width, **f32) + 0.5) / width).repeat(rings)[:, None]
    return PointBatch(pts, ok, rel_time)


def simulate_scan_moving(
    world: SimWorld,
    pose_start,
    pose_end,
    noise_normals,
    rings: int = 16,
    width: int = 900,
    elev_min: float = -0.26,
    elev_max: float = 0.26,
    max_range: float = 50.0,
    min_range: float = 1.0,
    noise: float = 0.01,
    device="cuda",
) -> PointBatch:
    """Motion-blurred scan: each azimuth column is cast from the sensor pose
    interpolated at its sweep time (constant twist between ``pose_start``
    and ``pose_end``), and the measured point is expressed in THAT pose's
    frame — the distortion a spinning lidar on a moving platform produces,
    which deskew must undo. Returns the points as measured (start-to-end
    sweep, rel-time attr in [0,1)), laid out as :func:`simulate_scan`'s.

    ``noise_normals``: (rings·width,) standard normals, ring-major, or a
    ``numpy.random.Generator`` to draw them from.
    """
    if isinstance(noise_normals, np.random.Generator):
        noise_normals = noise_normals.standard_normal(rings * width).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    pose_start = torch.as_tensor(pose_start, **f32)
    pose_end = torch.as_tensor(pose_end, **f32)
    elev = torch.linspace(elev_min, elev_max, rings, **f32)
    az = -math.pi + (torch.arange(width, **f32) + 0.5) * (2 * math.pi / width)
    rel = (torch.arange(width, **f32) + 0.5) / width  # (W,)
    xi = se3.pose_log(se3.pose_between(pose_start, pose_end))  # (6,)
    col_poses = se3.pose_compose(pose_start[None], se3.se3_exp(rel[:, None] * xi[None]))  # (W,7)

    ce, se_ = torch.cos(elev), torch.sin(elev)
    ca, sa = torch.cos(az), torch.sin(az)
    d_local = torch.stack(
        [
            ce[:, None] * ca[None, :],
            ce[:, None] * sa[None, :],
            se_[:, None].expand(rings, width),
        ],
        dim=-1,
    )  # (R,W,3)
    Rm = se3.quat_to_matrix(col_poses[:, :4])  # (W,3,3)
    d_world = torch.einsum("wij,rwj->rwi", Rm, d_local).reshape(-1, 3)
    origins = col_poses[:, 4:].expand(rings, width, 3).reshape(-1, 3)  # one a ray

    t = _ray_ground(origins, d_world, world.ground_z)
    t = torch.minimum(t, _ray_boxes(
        origins, d_world, torch.as_tensor(world.boxes_min, **f32),
        torch.as_tensor(world.boxes_max, **f32)))
    t = torch.minimum(t, _ray_cylinders(origins, d_world, torch.as_tensor(world.cylinders, **f32)))
    t = t + noise * torch.as_tensor(noise_normals, **f32).reshape(t.shape)
    ok = (t > min_range) & (t < max_range)
    pts = torch.where(ok[:, None], t[:, None] * d_local.reshape(-1, 3), 0.0)
    rel_attr = rel[None, :].expand(rings, width).reshape(-1, 1)
    return PointBatch(pts, ok, rel_attr.contiguous())
