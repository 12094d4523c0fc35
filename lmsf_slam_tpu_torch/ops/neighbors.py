"""Nearest-neighbour search.

Counterpart of ``lmsf_slam_tpu/ops/neighbors.py``. ``knn``, ``nn1`` and
``knn_with_neighbors`` go through the hand-written CUDA kernels on CUDA
tensors (:mod:`.knn`); ``radius_count`` is plain torch for now (its count
variant of the kernel is later work).
"""
from __future__ import annotations

import torch

from .knn import INF, knn, knn_with_neighbors  # noqa: F401  (re-exported: the port's k-NN)


def nn1(query_xyz, query_mask, ref_xyz, ref_mask):
    """1-NN squared distance and index (the flow/probation gate primitive)."""
    d, i = knn(query_xyz, query_mask, ref_xyz, ref_mask, k=1)
    return d[:, 0], i[:, 0]


def radius_count(query_xyz, query_mask, ref_xyz, ref_mask, radius):
    """Number of reference points within ``radius`` of each query point."""
    q = query_xyz.to(torch.float32)
    q_norm = torch.sum(q * q, dim=-1, keepdim=True)
    p_norm = torch.sum(ref_xyz * ref_xyz, dim=-1)
    d = q_norm + p_norm[None, :] - 2.0 * (q @ ref_xyz.T)
    inside = (d <= radius * radius) & ref_mask[None, :]
    counts = torch.sum(inside, dim=1, dtype=torch.int32)
    return torch.where(query_mask, counts, 0)


def gather_neighbors(ref_xyz, idx, dists):
    """Neighbour coordinates (Q,k,3) and validity (Q,k) from knn() output."""
    nbr = ref_xyz[idx.long()]
    valid = dists < INF
    return nbr, valid
