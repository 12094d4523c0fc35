"""Multi-trajectory / multi-session map fusion.

Counterpart of ``lmsf_slam_tpu/backend/session_merge.py``:

- ``align_sessions``: find the SE(3) transform taking session B's map frame
  into session A's by appearance relocalization — B's keyframes are queried
  against A's descriptor database (scan context → two-stage registration
  verify, the same machinery as boot relocalization) until enough
  consistent matches are found;
- ``merge_sessions``: transform B's keyframes/edges into A's frame, append
  them to A's database with re-indexed ids, and add the verified
  inter-session edges so a global optimize fuses both trajectories into one
  pose graph.

All search/verify work is the existing device work; the merge itself is
array bookkeeping with host pose math (:mod:`..common.se3np`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..common import se3np
from ..common.pointcloud import PointBatch
from .keyframe_db import KeyframeDatabase
from .loop_closure import LoopConfig, LoopDetector


class SessionAlignment(NamedTuple):
    transform: np.ndarray  # (7,) pose taking B-frame coords into A-frame
    matches: list  # [(a_id, b_id, pose_b_kf_in_A (7,))] verified matches
    n_tried: int


def _clouds_on(db_from: KeyframeDatabase, i: int, device):
    """Keyframe ``i``'s clouds of ``db_from`` on ``device`` (the database
    they are matched against or appended to)."""
    edge, surf = db_from.keyframe_clouds(i)
    if edge.xyz.device == device:
        return edge, surf
    return (PointBatch(edge.xyz.to(device), edge.mask.to(device)),
            PointBatch(surf.xyz.to(device), surf.mask.to(device)))


def align_sessions(
    db_a: KeyframeDatabase,
    db_b: KeyframeDatabase,
    loop_config: LoopConfig = LoopConfig(),
    min_matches: int = 3,
    max_queries: int = 40,
    consistency_tol: float = 1.0,  # m: agreement between match-implied transforms
) -> Optional[SessionAlignment]:
    """Estimate T_A←B by relocalizing session B's keyframes inside A."""
    detector = LoopDetector(loop_config)
    matches = []
    transforms = []
    n = db_b.n_keyframes
    stride = max(1, n // max_queries)
    tried = 0
    for b_id in range(0, n, stride):
        tried += 1
        edge, surf = _clouds_on(db_b, b_id, db_a.device)
        res = detector.relocalize(db_a, edge, surf)
        if res is None:
            continue
        pose_in_a = np.asarray(res.pose)
        # implied frame transform: T = pose_in_A ∘ pose_in_B⁻¹
        t = np.asarray(
            se3np.pose_compose(pose_in_a, se3np.pose_inverse(db_b.map_poses[b_id])),
            np.float32,
        )
        matches.append((res.matched_id, b_id, pose_in_a))
        transforms.append(t)
    if len(matches) < min_matches:
        return None
    # consistency: keep the largest cluster of agreeing transforms
    T = np.stack(transforms)
    d = np.linalg.norm(T[:, None, 4:] - T[None, :, 4:], axis=-1)
    support = (d < consistency_tol).sum(axis=1)
    best = int(np.argmax(support))
    keep = np.nonzero(d[best] < consistency_tol)[0]
    if keep.size < min_matches:
        return None
    # average the consistent cluster (chordal quaternion mean + median trans)
    qs = T[keep, :4]
    qs = np.where((qs @ qs[0])[:, None] < 0, -qs, qs)
    q = qs.mean(axis=0)
    q /= max(np.linalg.norm(q), 1e-12)
    t = np.median(T[keep, 4:], axis=0)
    return SessionAlignment(
        transform=np.concatenate([q, t]).astype(np.float32),
        matches=[matches[int(k)] for k in keep],
        n_tried=tried,
    )


def merge_sessions(
    db_a: KeyframeDatabase,
    db_b: KeyframeDatabase,
    alignment: SessionAlignment,
    inter_session_noise=None,
) -> int:
    """Append session B (transformed into A's frame) to ``db_a`` in place,
    with inter-session edges from the verified matches. Returns the id
    offset of B's keyframes inside the merged database."""
    if inter_session_noise is None:
        inter_session_noise = np.array([0.0025] * 3 + [0.01] * 3)
    T = np.asarray(alignment.transform, np.float32)
    offset = db_a.n_keyframes
    nb = db_b.n_keyframes
    for i in range(nb):
        edge, surf = _clouds_on(db_b, i, db_a.device)
        db_a.add_keyframe(
            float(db_b.stamps[i]),
            db_b.odom_poses[i],
            np.asarray(se3np.pose_compose(T, db_b.map_poses[i]), np.float32),
            edge,
            surf,
            sc=db_b.sc[i],
            gnss_pos=db_b.gnss_pos[i] if db_b.gnss_valid[i] else None,
        )
    # B's internal edges, re-indexed (loop markings carried through so the
    # per-edge robust-kernel policy survives the merge)
    for e in range(db_b.n_edges):
        i, j = db_b.eij[e]
        noise = 1.0 / np.maximum(db_b.esqrtw[e], 1e-12) ** 2
        db_a.add_edge(
            int(i) + offset, int(j) + offset, db_b.ez[e], noise,
            loop=bool(db_b.eloop[e]),
        )
    # verified inter-session edges: A-node → B-node — loop-closure-class
    # constraints (appearance-verified), so they get the robust kernel
    for a_id, b_id, pose_in_a in alignment.matches:
        z = np.asarray(se3np.pose_between(db_a.map_poses[a_id], pose_in_a), np.float32)
        db_a.add_edge(int(a_id), int(b_id) + offset, z, inter_session_noise, loop=True)
    return offset
