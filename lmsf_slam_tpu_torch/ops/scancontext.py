"""Scan Context appearance descriptors on torch tensors.

Counterpart of ``lmsf_slam_tpu/ops/scancontext.py``: 20 rings × 60 sectors ×
80 m polar binning of the max shifted height (one scatter-max), the
rotation-invariant ring key (row means), the circular column-shift alignment
with cosine column distance evaluated for all shifts of all candidates in one
einsum, and the two-stage place search over a padded descriptor database
(ring-key distance → top candidates → full shifted distance).

The reference computes all of this outside any hand-written kernel, and so
does the port: plain torch ops, with TF32 off (the package sets it) so the
einsum is true float32. ``lax.top_k`` and ``argmin`` break ties by the lowest
index; ``torch.topk`` promises no order among ties, so the candidate ranking
is a stable sort (``torch.argmin`` returns the first minimum, as documented).
"""
from __future__ import annotations

import math

import torch

from ..common.pointcloud import PointBatch

RINGS = 20
SECTORS = 60
MAX_RANGE = 80.0
Z_OFFSET = 2.0  # lidar height shift so bin values are positive

_FAR = 3.4e38  # distance of an invalid database row


def make_scan_context(
    pb: PointBatch,
    rings: int = RINGS,
    sectors: int = SECTORS,
    max_range: float = MAX_RANGE,
    z_offset: float = Z_OFFSET,
) -> torch.Tensor:
    """(rings, sectors) descriptor: max shifted-z per polar bin, 0 if empty."""
    xyz = pb.xyz
    r = torch.linalg.vector_norm(xyz[:, :2], dim=-1)
    az = torch.atan2(xyz[:, 1], xyz[:, 0])  # [-pi, pi]
    # float → int32 truncates toward zero in both packages (r ≥ 0, az+π ≥ 0)
    ring = torch.clamp((r / max_range * rings).to(torch.int32), 0, rings - 1)
    sector = torch.clamp(
        ((az + math.pi) / (2 * math.pi) * sectors).to(torch.int32), 0, sectors - 1
    )
    val = torch.clamp(xyz[:, 2] + z_offset, min=0.0)
    ok = pb.mask & (r < max_range)
    # points that do not count land in an overflow bin past the descriptor
    bin_id = torch.where(ok, ring * sectors + sector, rings * sectors).long()
    sc = torch.zeros(rings * sectors + 1, dtype=xyz.dtype, device=xyz.device)
    sc.scatter_reduce_(0, bin_id, torch.where(ok, val, 0.0), "amax", include_self=True)
    return sc[:-1].reshape(rings, sectors)


def ring_key(sc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant key: per-ring mean over sectors.
    Works batched: (..., R, S) -> (..., R)."""
    return torch.mean(sc, dim=-1)


def sc_distance(query: torch.Tensor, cands: torch.Tensor):
    """Min-over-shifts cosine column distance between a query (R, S) and
    candidate descriptors (..., R, S).

    Returns (dist (...,), shift (...,) int32): the distance is the mean of
    (1 − cos) over columns where both descriptors are non-empty, minimized
    over all circular sector shifts; ``shift`` is the aligning shift
    (candidate rolled by +shift matches the query), the lowest on a tie.
    """
    R, S = query.shape
    ar = torch.arange(S, device=query.device)
    cols = (ar[None, :] + ar[:, None]) % S
    q_shift = query[:, cols].permute(1, 0, 2)  # (S_shifts, R, S)
    qn = torch.linalg.vector_norm(q_shift, dim=1)  # (S, S) per-column norms
    cn = torch.linalg.vector_norm(cands, dim=-2)  # (..., S)
    dots = torch.einsum("srj,...rj->...sj", q_shift, cands)  # (..., S_shift, S)
    both = (qn > 1e-6) & (cn[..., None, :] > 1e-6)
    cos = dots / torch.clamp(qn * cn[..., None, :], min=1e-6)
    n_both = torch.sum(both, dim=-1)
    dist_per_shift = torch.sum(torch.where(both, 1.0 - cos, 0.0), dim=-1) / torch.clamp(
        n_both, min=1
    )
    # empty-overlap shifts are meaningless — give them max distance
    dist_per_shift = torch.where(n_both > 0, dist_per_shift, 2.0)
    shift = torch.argmin(dist_per_shift, dim=-1)
    dist = torch.take_along_dim(dist_per_shift, shift[..., None], dim=-1)[..., 0]
    return dist, shift.to(torch.int32)


def shift_to_yaw(shift: torch.Tensor, sectors: int = SECTORS) -> torch.Tensor:
    """Aligning sector shift -> relative yaw (rad), wrapped to (-pi, pi].

    A shift of +s means the candidate viewed from the query frame is rotated
    by yaw = 2π·s/sectors."""
    yaw = 2.0 * math.pi * shift.to(torch.float32) / sectors
    return torch.where(yaw > math.pi, yaw - 2.0 * math.pi, yaw)


def sc_search(
    query_sc: torch.Tensor,
    db_sc: torch.Tensor,
    db_ring_key: torch.Tensor,
    db_valid: torch.Tensor,
    num_candidates: int = 10,
):
    """Two-stage place search over a padded descriptor database.

    Stage 1: ring-key L2 distance over the whole DB → the ``num_candidates``
    nearest rows (lowest index first among equals).
    Stage 2: full shifted SC distance on those candidates.

    Returns (best_id int32, best_dist f32, yaw f32) as 0-dim tensors; nothing
    is read back here. best_id is −1 when the DB has no valid entries;
    callers gate on a distance threshold.
    """
    qk = ring_key(query_sc)  # (R,)
    d = torch.sum((db_ring_key - qk[None, :]) ** 2, dim=-1)
    d = torch.where(db_valid, d, _FAR)
    cand = torch.sort(d, stable=True).indices[:num_candidates]
    dist, shift = sc_distance(query_sc, db_sc[cand])
    dist = torch.where(db_valid[cand], dist, _FAR)
    best = torch.argmin(dist)
    any_valid = torch.any(db_valid)
    best_id = torch.where(any_valid, cand[best], -1).to(torch.int32)
    return best_id, dist[best], shift_to_yaw(shift[best])


def sc_search_id(
    query_id,
    db_sc: torch.Tensor,
    db_ring_key: torch.Tensor,
    db_valid: torch.Tensor,
    num_candidates: int = 10,
):
    """``sc_search`` with the query taken from the database itself (row
    ``query_id``) — the loop-detection case, where the query keyframe's
    descriptor already lives in the device mirror: no descriptor is copied
    to the card."""
    return sc_search(db_sc[int(query_id)], db_sc, db_ring_key, db_valid, num_candidates)
