"""Voxel-grid downsampling.

Counterpart of ``lmsf_slam_tpu/ops/voxel.py::voxel_downsample``: integer
voxel keys on a 1024³ lattice snapped to the cloud's centroid → stable sort →
segment boundaries → scatter-mean into a fixed output capacity. The output
slot order is the reference's (ascending key), because the tracker's maps are
indexed by slot. (``voxel_gaussians`` and the voxel lookups come with NDT.)
"""
from __future__ import annotations

import torch

from ..common.pointcloud import PointBatch

# grid is G³ cells, centered on the centroid of the valid points.
_G = 1024  # 2^30 linear ids < int32 max
_KEY_INVALID = 2**31 - 1


def _snap_origin(xyz, mask, voxel_size):
    """Grid origin: cloud centroid snapped to the global voxel lattice, so
    cell boundaries are identical across clouds (deterministic binning)."""
    cnt = torch.clamp(torch.sum(mask), min=1)
    centroid = torch.sum(torch.where(mask[:, None], xyz, 0.0), dim=0) / cnt
    return torch.floor(centroid / voxel_size) * voxel_size


def _voxel_keys(xyz, mask, voxel_size, origin):
    ci = torch.floor((xyz - origin) / voxel_size).to(torch.int32) + _G // 2
    ci = torch.clamp(ci, 0, _G - 1)
    key = (ci[:, 0] * _G + ci[:, 1]) * _G + ci[:, 2]
    return torch.where(mask, key, _KEY_INVALID)


def _sum_dtype(xyz):
    """The type the voxel sums are taken in. On a card index_add_ adds with
    atomics in no fixed order, and a float32 sum that changes in its last bit
    from run to run moves a centroid across a cell boundary at the next
    rebuild, which a long course amplifies into decimetres. So CUDA tensors
    are summed in float64 and rounded once: a float64 sum of a voxel's few
    float32 terms rounds to the same float32 whatever the order. On the CPU
    index_add_ adds in index order, as the reference's segment_sum does, and
    float32 repeats and equals the reference bit for bit."""
    return torch.float64 if xyz.is_cuda else xyz.dtype


def voxel_downsample(pb: PointBatch, voxel_size: float, out_capacity: int) -> PointBatch:
    """Scatter-mean voxel downsample to a fixed-capacity PointBatch."""
    mask = pb.mask
    origin = _snap_origin(pb.xyz, mask, voxel_size)
    keys = _voxel_keys(pb.xyz, mask, voxel_size, origin)
    skeys, order = torch.sort(keys, stable=True)
    sxyz = pb.xyz[order]
    smask = mask[order]
    sattr = pb.attr[order]
    is_start = torch.cat([skeys.new_ones(1, dtype=torch.bool), skeys[1:] != skeys[:-1]])
    seg = torch.cumsum(is_start.to(torch.int32), dim=0) - 1
    # invalid points and voxels past the capacity go to one extra slot that
    # is cut off (the reference's segment_sum drops out-of-range segment ids;
    # index_add_ would raise, and a boolean filter would cost a host sync)
    seg = torch.where(smask & (seg < out_capacity), seg, out_capacity).long()
    A = pb.attr.shape[-1]
    both = torch.cat([sxyz, sattr, smask.to(sxyz.dtype)[:, None]], dim=1).to(_sum_dtype(sxyz))
    acc = both.new_zeros((out_capacity + 1, 4 + A)).index_add_(0, seg, both)[:-1]
    counts = acc[:, 3 + A]
    denom = torch.clamp(counts, min=1.0)[:, None]
    mean = (acc[:, :3 + A] / denom).to(pb.xyz.dtype)
    return PointBatch(mean[:, :3], counts > 0, mean[:, 3:])
