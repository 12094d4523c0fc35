"""Voxel-grid operations: downsampling and voxel Gaussian statistics.

Counterpart of ``lmsf_slam_tpu/ops/voxel.py`` (``voxel_downsample``,
``voxel_gaussians``, ``voxel_lookup``, ``voxel_lookup7``): integer voxel keys
on a 1024³ lattice snapped to the cloud's centroid → stable sort → segment
boundaries → scatter sums into a fixed output capacity. The output slot order
is the reference's (ascending key), because the tracker's maps are indexed by
slot and NDT looks voxels up by a binary search on the sorted keys.
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


def _segments(pb: PointBatch, voxel_size: float, capacity: int):
    """(origin, sorted keys, the sort order, segment of each sorted point):
    invalid points and segments past ``capacity`` get segment ``capacity``,
    one extra row that the caller cuts off (the reference's segment_sum drops
    out-of-range segment ids; index_add_ would raise, and a boolean filter
    would cost a host sync)."""
    mask = pb.mask
    origin = _snap_origin(pb.xyz, mask, voxel_size)
    keys = _voxel_keys(pb.xyz, mask, voxel_size, origin)
    skeys, order = torch.sort(keys, stable=True)
    is_start = torch.cat([skeys.new_ones(1, dtype=torch.bool), skeys[1:] != skeys[:-1]])
    seg = torch.cumsum(is_start.to(torch.int32), dim=0) - 1
    seg = torch.where(mask[order] & (seg < capacity), seg, capacity).long()
    return origin, skeys, order, seg


def voxel_downsample(pb: PointBatch, voxel_size: float, out_capacity: int) -> PointBatch:
    """Scatter-mean voxel downsample to a fixed-capacity PointBatch."""
    _, _, order, seg = _segments(pb, voxel_size, out_capacity)
    sxyz = pb.xyz[order]
    smask = pb.mask[order]
    sattr = pb.attr[order]
    A = pb.attr.shape[-1]
    both = torch.cat([sxyz, sattr, smask.to(sxyz.dtype)[:, None]], dim=1).to(_sum_dtype(sxyz))
    acc = both.new_zeros((out_capacity + 1, 4 + A)).index_add_(0, seg, both)[:-1]
    counts = acc[:, 3 + A]
    denom = torch.clamp(counts, min=1.0)[:, None]
    mean = (acc[:, :3 + A] / denom).to(pb.xyz.dtype)
    return PointBatch(mean[:, :3], counts > 0, mean[:, 3:])


def voxel_gaussians(pb: PointBatch, voxel_size: float, max_voxels: int):
    """Per-voxel Gaussian statistics (mean, covariance, count) for NDT-style
    registration. Returns a dict of padded tensors:

      means: (V, 3), covs: (V, 3, 3), counts: (V,), keys: (V,) sorted int32
      (unused slots 2**31 − 1), origin: (3,), valid: (V,) bool (count ≥ 3,
      as NDT requires), voxel_size: () float32.

    The covariance is E[xxᵀ] − μμᵀ, which cancels catastrophically in float32
    at city coordinates (entries ~1e4 m² against a covariance of ~1e-2 m²).
    On a card the sums, means and covariances are taken in float64 and
    rounded once (:func:`_sum_dtype`); the CPU keeps the reference's float32
    sums and means, so it carries the reference's cancellation.
    """
    origin, skeys, order, seg = _segments(pb, voxel_size, max_voxels)
    sxyz = pb.xyz[order].to(_sum_dtype(pb.xyz))
    w = (seg < max_voxels).to(sxyz.dtype)  # the points that land in a kept voxel
    outer = (sxyz[:, :, None] * sxyz[:, None, :]).reshape(-1, 9)
    both = torch.cat([w[:, None], sxyz, outer], dim=1) * w[:, None]
    acc = both.new_zeros((max_voxels + 1, 13)).index_add_(0, seg, both)[:-1]
    s1 = acc[:, 0]
    n = torch.clamp(s1, min=1.0)
    mean = acc[:, 1:4] / n[:, None]
    # E[xxᵀ] − μμᵀ with one rounding: the product exact in float64, as the
    # reference's compiled float32 code takes it in a fused multiply-add
    m64 = mean.to(torch.float64)
    cov = (acc[:, 4:].reshape(-1, 3, 3) / n[:, None, None]).to(torch.float64) - (
        m64[:, :, None] * m64[:, None, :])
    cov = cov.to(pb.xyz.dtype)
    # regularize (NDT epsilon-inflation of near-singular covariances)
    cov = cov + 1e-3 * voxel_size * voxel_size * torch.eye(3, dtype=cov.dtype, device=cov.device)
    # the key of each slot: every point of a segment carries it
    slot_key = torch.full((max_voxels + 1,), _KEY_INVALID, dtype=torch.int32,
                          device=skeys.device).scatter_(0, seg, skeys)[:-1]
    counts = s1.to(pb.xyz.dtype)
    return {
        "means": mean.to(pb.xyz.dtype),
        "covs": cov,
        "counts": counts,
        "keys": slot_key,
        "origin": origin,
        "valid": counts >= 3.0,
        "voxel_size": torch.full((), voxel_size, dtype=torch.float32, device=pb.xyz.device),
    }


def _lookup(gaussians, ci):
    """Slots and found flags of lattice cells ``ci`` (..., 3) int32."""
    ci = torch.clamp(ci, 0, _G - 1)
    qkey = (ci[..., 0] * _G + ci[..., 1]) * _G + ci[..., 2]
    keys = gaussians["keys"]
    slot = torch.searchsorted(keys, qkey.reshape(-1)).reshape(qkey.shape)
    slot = torch.clamp(slot, 0, keys.shape[0] - 1)
    found = (keys[slot] == qkey) & gaussians["valid"][slot]
    return slot.to(torch.int32), found


def _cells(gaussians, query_xyz):
    vs = gaussians["voxel_size"]
    return torch.floor((query_xyz - gaussians["origin"]) / vs).to(torch.int32) + _G // 2


def voxel_lookup(gaussians, query_xyz: torch.Tensor):
    """Map each query point to its voxel slot via binary search on sorted keys.

    Returns (slot_idx int32, found) — found=False when the voxel is unoccupied
    or holds fewer than 3 points.
    """
    return _lookup(gaussians, _cells(gaussians, query_xyz))


def voxel_lookup7(gaussians, query_xyz: torch.Tensor):
    """DIRECT7 lookup (ndt_omp's default): each query maps to its own voxel
    plus the 6 face neighbors (+x, −x, +y, −y, +z, −z), so residuals stay
    smooth across cell boundaries.

    Returns (slots (N,7) int32, found (N,7)).
    """
    # made on the device, so a call copies nothing from the host
    eye = torch.eye(3, dtype=torch.int32, device=query_xyz.device)
    offsets = torch.stack([eye[0] * 0, eye[0], -eye[0], eye[1], -eye[1], eye[2], -eye[2]])
    return _lookup(gaussians, _cells(gaussians, query_xyz)[:, None, :] + offsets[None, :, :])
