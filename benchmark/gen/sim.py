"""Frozen ray-cast LiDAR simulator and courses, in plain PyTorch.

A copy of the port's ``datasets/simulator.py`` world and scan renderer and of
the looped course of its smoke runs, kept here so that no change to the
program can move the benchmark's inputs. It imports nothing of the program.

A world is ground + axis-aligned boxes + vertical cylinders; a scan is one
range return a (ring, azimuth) beam, cast on the card from a pose
``[qw qx qy qz x y z]`` and returned in the sensor frame with a relative-time
attribute, as the simulator the port was written against renders it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..reference.se3 import qmat

BIG = 1e9


def make_world(rng: np.random.Generator, extent=30.0, extent_y=None, n_boxes=14,
               n_cylinders=24, box_size=(2.0, 6.0), box_height=(2.0, 6.0),
               cyl_radius=(0.15, 0.5), cyl_height=5.0, clear_radius=4.0):
    """Boxes (min, max) and cylinders ``[cx, cy, r, h]`` inside ±extent,
    none within ``clear_radius`` (plus a margin) of the origin; with
    ``extent_y`` a strip ±extent long and ±extent_y across, none within that
    distance of the x axis. With ``extent_y`` None the draws are the port's
    ``make_sim_world``'s, number for number."""
    ey = extent if extent_y is None else extent_y

    def place(n, margin):
        lo = clear_radius + margin
        if extent_y is None:
            xy = rng.uniform(-extent, extent, (n, 2)).astype(np.float32)
            r = np.linalg.norm(xy, axis=1, keepdims=True)
            scale = np.where(r < lo, lo / np.maximum(r, 1e-3), 1.0)
            return (xy * scale).astype(np.float32)
        # a strip: the clear band runs along the x axis, where the drive is
        x = rng.uniform(-extent, extent, n)
        y = rng.uniform(-ey, ey, n)
        y = np.where(np.abs(y) < lo, np.copysign(lo, y), y)
        return np.stack([x, y], axis=1).astype(np.float32)

    bxy = place(n_boxes, 4.0)
    bwh = rng.uniform(box_size[0], box_size[1], (n_boxes, 2)).astype(np.float32)
    bh = rng.uniform(box_height[0], box_height[1], (n_boxes, 1)).astype(np.float32)
    bmin = np.concatenate([bxy - bwh / 2, np.zeros((n_boxes, 1), np.float32)], axis=1)
    bmax = np.concatenate([bxy + bwh / 2, bh], axis=1)
    cxy = place(n_cylinders, 1.0)
    cr = rng.uniform(cyl_radius[0], cyl_radius[1], (n_cylinders, 1)).astype(np.float32)
    cyl = np.concatenate([cxy, cr, np.full((n_cylinders, 1), cyl_height, np.float32)], axis=1)
    return {"boxes_min": bmin, "boxes_max": bmax, "cylinders": cyl, "ground_z": 0.0}


def _hit_boxes(o, d, bmin, bmax):
    """Ray parameter of the nearest box hit of each ray; ``o`` is one origin
    (3,) or one a ray (M,3)."""
    if bmin.shape[0] == 0:
        return torch.full_like(d[:, 0], BIG)
    o = o.reshape(-1, 1, 3)
    inv = 1.0 / torch.where(torch.abs(d) > 1e-9, d, 1e-9)
    t1 = (bmin[None] - o) * inv[:, None, :]
    t2 = (bmax[None] - o) * inv[:, None, :]
    tnear = torch.amax(torch.minimum(t1, t2), dim=2)
    tfar = torch.amin(torch.maximum(t1, t2), dim=2)
    hit = (tnear <= tfar) & (tfar > 0) & (tnear > 0)
    return torch.amin(torch.where(hit, tnear, BIG), dim=1)


def _hit_cylinders(o, d, cyl):
    """As :func:`_hit_boxes`, for the vertical cylinders."""
    if cyl.shape[0] == 0:
        return torch.full_like(d[:, 0], BIG)
    o = o.reshape(-1, 3)
    ox, oy = o[:, 0:1] - cyl[:, 0], o[:, 1:2] - cyl[:, 1]
    dx, dy = d[:, 0:1], d[:, 1:2]
    a = torch.clamp(dx * dx + dy * dy, min=1e-9)
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - cyl[:, 2] * cyl[:, 2]
    disc = b * b - 4 * a * c
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
    z = o[:, 2:3] + t * d[:, 2:3]
    hit = (disc > 0) & (t > 0) & (z > 0) & (z < cyl[:, 3])
    return torch.amin(torch.where(hit, t, BIG), dim=1)


class Renderer:
    """Renders organized scans of one sensor on ``device``; the world's
    arrays are moved there once."""

    def __init__(self, rings=16, width=900, elev_min=-0.26, elev_max=0.26, max_range=60.0,
                 min_range=1.0, noise=0.01, device="cuda"):
        self.rings, self.width = rings, width
        self.max_range, self.min_range, self.noise = max_range, min_range, noise
        self.device = torch.device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        elev = torch.linspace(elev_min, elev_max, rings, **f32)
        az = -math.pi + (torch.arange(width, **f32) + 0.5) * (2 * math.pi / width)
        self.d_local = torch.stack([
            torch.cos(elev)[:, None] * torch.cos(az)[None, :],
            torch.cos(elev)[:, None] * torch.sin(az)[None, :],
            torch.sin(elev)[:, None].expand(rings, width),
        ], dim=-1).reshape(-1, 3)
        self.rel_time = ((torch.arange(width, **f32) + 0.5) / width).repeat(rings)[:, None]

    def scan(self, world, pose, normals):
        """(xyz (M,3), mask (M,), attr (M,1)) of the scan from ``pose``;
        ``normals`` are M standard normals on the device (the range noise)."""
        pose = torch.as_tensor(np.asarray(pose, np.float32), dtype=torch.float32,
                               device=self.device)
        return self.cast(world, pose[4:], self.d_local @ qmat(pose[:4]).T, normals)

    def cast(self, world, o, d, normals):
        """The scan of the rays ``d`` (M,3, in the world frame) from ``o``,
        one origin (3,) or one a ray (M,3), each return laid along its beam
        of :attr:`d_local`, as :meth:`scan` lays it."""
        f32 = dict(dtype=torch.float32, device=self.device)
        o = o.reshape(-1, 3)
        dz = d[:, 2]
        ok = torch.abs(dz) > 1e-9
        tg = (world["ground_z"] - o[:, 2]) / torch.where(ok, dz, 1e-9)
        t = torch.where(ok & (tg > 0), tg, BIG)
        t = torch.minimum(t, _hit_boxes(o, d, torch.as_tensor(world["boxes_min"], **f32),
                                        torch.as_tensor(world["boxes_max"], **f32)))
        t = torch.minimum(t, _hit_cylinders(o, d, torch.as_tensor(world["cylinders"], **f32)))
        t = t + self.noise * normals.reshape(t.shape)
        ok = (t > self.min_range) & (t < self.max_range)
        xyz = torch.where(ok[:, None], t[:, None] * self.d_local, 0.0)
        return xyz, ok, self.rel_time


def yaw_poses(x, y, yaw, z):
    """(n, 7) float32 poses with heading ``yaw`` at (x, y, z)."""
    n = len(x)
    q = np.stack([np.cos(yaw / 2), np.zeros(n), np.zeros(n), np.sin(yaw / 2)], axis=1)
    return np.concatenate([q, np.stack([x, y, np.full(n, z)], axis=1)], axis=1).astype(np.float32)


def circle_course(n_frames, frames_per_lap=120, radius=9.0, z=1.4):
    """Laps of a circle, counterclockwise from (radius, 0), heading along the
    tangent; frame k sits at angle 2πk/frames_per_lap, so lap after lap the
    poses repeat without a doubled frame at the seam."""
    th = 2 * np.pi * np.arange(n_frames) / frames_per_lap
    return yaw_poses(radius * np.cos(th), radius * np.sin(th), th + np.pi / 2, z)


def line_course(n_frames, step, start_x, y=0.0, z=1.4):
    """A straight drive along +x from ``start_x`` at ``step`` m a frame."""
    x = start_x + step * np.arange(n_frames)
    return yaw_poses(x, np.full(n_frames, y), np.zeros(n_frames), z)
