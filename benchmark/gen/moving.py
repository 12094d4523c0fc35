"""Frozen motion-blurred sweep, a copy of the port's
``datasets/simulator.py::simulate_scan_moving`` on the geometry of a
:class:`.sim.Renderer`, in plain PyTorch. Nothing of the program is imported.

Each azimuth column is cast from the sensor pose interpolated at its sweep
time (a constant twist from the start pose to the end pose) and the point is
returned in THAT pose's frame: the distortion a spinning LiDAR on a moving
platform produces, which deskew has to undo. The column poses are worked out
in float64 and cast in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference import se3


def column_poses(width, pose_start, pose_end, device):
    """(W,7) float32 sensor pose of each azimuth column at its sweep time
    (column w at (w + 0.5) / W of the way), on ``device``."""
    f64 = dict(dtype=torch.float64, device=device)
    p0, p1 = (torch.as_tensor(np.asarray(p, np.float32), **f64) for p in (pose_start, pose_end))
    rel = (torch.arange(width, **f64) + 0.5) / width
    xi = se3.log(se3.between(p0, p1))
    return se3.compose(p0.expand(width, 7), se3.exp(rel[:, None] * xi[None])).float()


def cast_columns(renderer, world, cols, normals):
    """The sweep cast from column poses ``cols`` (W,7), each point in its
    own column's sensor frame."""
    r = renderer
    d_local = r.d_local.reshape(r.rings, r.width, 3)
    d = torch.einsum("wij,rwj->rwi", se3.qmat(cols[:, :4]), d_local).reshape(-1, 3)
    o = cols[:, 4:].expand(r.rings, r.width, 3).reshape(-1, 3)
    return r.cast(world, o, d, normals)


def scan_moving(renderer, world, pose_start, pose_end, normals):
    """(xyz (M,3), mask (M,), attr (M,1)) of the sweep from ``pose_start``
    to ``pose_end``, laid out as :meth:`.sim.Renderer.scan`'s, each point in
    the sensor frame of its own column's time (the attribute)."""
    cols = column_poses(renderer.width, pose_start, pose_end, renderer.device)
    return cast_columns(renderer, world, cols, normals)
