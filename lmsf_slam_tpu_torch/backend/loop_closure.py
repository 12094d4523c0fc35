"""Loop detection + appearance relocalization.

Counterpart of ``lmsf_slam_tpu/backend/loop_closure.py``:

- two-stage candidate search: scan-context first, geometric position search
  as fallback;
- candidates must be old enough (≥ ``min_frame_interval`` keyframes) and,
  for the position fallback, within ``search_radius``;
- two-stage geometric verification: rough registration (wide correspondence
  gate) → alignment evaluation (gate ``rough_score_thresh``) → refined
  registration → alignment evaluation (gate ``refine_score_thresh``);
- relocalization: scan-context best match → rough+refine registration vs the
  ±``adjacent_window`` local map of the match → accept at score ≤
  ``reloc_score_thresh``.

The descriptor search runs on the card over the padded descriptor mirror;
verification is the fused edge/surf GN registration at two correspondence
gates. The reference skips the refine stage with a ``lax.cond``; here the
rough score is read back and the host branches, which costs one small copy
and spares the whole refine stage when the gate fails. The verification's
result comes to the host in one packed copy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..common import se3np
from ..common.pointcloud import PointBatch
from ..ops import scancontext
from ..ops.registration import (
    RegistrationParams,
    evaluate_alignment,
    register_edge_surf,
)
from ..utils.profiling import StageTimer
from .keyframe_db import KeyframeDatabase


def _verify_fused(
    edge: PointBatch,
    surf: PointBatch,
    map_edge: PointBatch,
    map_surf: PointBatch,
    init_pose,
    rough_params: RegistrationParams,
    refine_params: RegistrationParams,
    rough_thresh,
    min_overlap,
):
    """The two-stage geometric verification — rough registration →
    alignment gate → refined registration → alignment. The refine stage runs
    only when the rough score passes ``rough_thresh`` (one read-back decides).
    Returns (pose, score, overlap, converged, n_constrained, rough_score) as
    tensors; a failed rough gate gives the rough pose with score 1e9, not
    converged, 0 constrained directions."""
    rough = register_edge_surf(edge, surf, map_edge, map_surf, init_pose, rough_params)
    r_score, r_overlap = evaluate_alignment(surf, map_surf, rough.pose, min_overlap=min_overlap)
    if bool(r_score <= rough_thresh):
        refined = register_edge_surf(edge, surf, map_edge, map_surf, rough.pose, refine_params)
        s, o = evaluate_alignment(surf, map_surf, refined.pose, min_overlap=min_overlap)
        return refined.pose, s, o, refined.converged, refined.n_constrained, r_score
    dev = rough.pose.device
    return (
        rough.pose,
        torch.tensor(1e9, dtype=torch.float32, device=dev),
        r_overlap,
        torch.zeros((), dtype=torch.bool, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        r_score,
    )


class LoopConfig(NamedTuple):
    sc_dist_thresh: float = 0.2  # scan-context distance gate
    exclude_recent: int = 50  # newest KFs excluded from search
    min_frame_interval: int = 100  # candidate must be ≥ this much older
    detect_spacing: int = 3  # frames between detection attempts
    search_radius: float = 10.0  # position-fallback radius
    adjacent_window: int = 5  # ±KFs in the verification local map
    rough_score_thresh: float = 1.0
    refine_score_thresh: float = 0.05
    reloc_score_thresh: float = 0.05
    min_overlap: float = 0.5  # alignment evaluator overlap gate
    # odometry-plausibility gate: a verified loop implies a map-frame
    # correction of the query pose; reject corrections larger than this, so
    # a wrong-basin registration in a self-similar world cannot rewrite the
    # trajectory (set to inf for kidnapped-robot regimes).
    max_correction_trans: float = 10.0
    # loop-edge noise (σ²) [rot×3, trans×3] at the WORST accepted
    # verification score; the information matrix is scaled by the fitness
    # score, so a tightly-verified loop carries a stiffer edge than one that
    # barely passed the gate. The σ scale factor interpolates linearly in
    # score from ``loop_info_best_scale`` (at score ≤ loop_score_best) to
    # 1.0 (at score = refine_score_thresh).
    loop_noise_rot: float = 0.0025
    loop_noise_trans: float = 0.01
    loop_score_best: float = 0.005  # scores at/below this get the stiffest edge
    loop_info_best_scale: float = 0.3  # σ multiplier at the best score
    # verification registrations use the match-count-normalized degeneracy
    # floor (0.01·n_matches): the 6/6-constraint accept gate must measure
    # geometry, not feature density
    rough_params: RegistrationParams = RegistrationParams(
        max_iters=8, max_corr_dist=4.0, huber_delta=2.0, degen_rel=0.01
    )
    refine_params: RegistrationParams = RegistrationParams(
        max_iters=10, max_corr_dist=1.0, degen_rel=0.01
    )


class LoopResult(NamedTuple):
    from_id: int  # historical keyframe
    to_id: int  # new keyframe
    z: np.ndarray  # (7,) relative pose from→to (in from's frame)
    noise: np.ndarray  # (6,) σ² [rot, trans]
    score: float
    overlap: float


class RelocResult(NamedTuple):
    pose: np.ndarray  # (7,) map-frame pose of the query scan
    matched_id: int
    score: float
    overlap: float


def _yaw_init(cand_pose: np.ndarray, yaw: float) -> np.ndarray:
    """The candidate's pose rotated by the scan-context yaw alignment (the
    SC match carries no translation). Host pose math, float32 out."""
    yaw_rot = se3np.so3_exp_quat(np.array([0.0, 0.0, yaw], np.float32))
    return np.asarray(
        se3np.pose_compose(cand_pose, se3np.make_pose(yaw_rot, np.zeros(3))), np.float32
    )


class LoopDetector:
    """Host-orchestrated loop detection over device search and verification."""

    def __init__(self, config: LoopConfig = LoopConfig(), timer=None):
        self.config = config
        self.timer = timer if timer is not None else StageTimer()
        self._last_attempt = -(10**9)

    # -- candidate search ---------------------------------------------------

    @staticmethod
    def _read_search(best_id, dist, yaw):
        """One copy to the host of a search result: (id, distance, yaw)."""
        packed = torch.stack([best_id.to(torch.float32), dist, yaw]).cpu().numpy()
        return int(packed[0]), float(packed[1]), float(packed[2])

    def _sc_candidate(self, db: KeyframeDatabase, query_id: int, newest_id: int):
        """Appearance candidate for keyframe ``query_id`` — the query
        descriptor is taken from the device mirror inside the search."""
        cfg = self.config
        sc_db, rk_db, valid = db.descriptor_arrays()
        cutoff = newest_id - max(cfg.exclude_recent, cfg.min_frame_interval)
        if cutoff <= 0:
            return None
        valid = valid & (torch.arange(valid.shape[0], device=valid.device) < cutoff)
        best_id, dist, yaw = self._read_search(
            *scancontext.sc_search_id(query_id, sc_db, rk_db, valid)
        )
        if best_id < 0 or dist > cfg.sc_dist_thresh:
            return None
        return best_id, yaw

    def _position_candidate(self, db: KeyframeDatabase, query_xyz, newest_id: int):
        cfg = self.config
        cutoff = newest_id - cfg.min_frame_interval
        if cutoff <= 0:
            return None
        ids, d = db.nearest_ids(np.asarray(query_xyz), 1, max_id=cutoff)
        if ids.size == 0 or d[0] > cfg.search_radius:
            return None
        return int(ids[0]), 0.0  # no yaw prior from geometry

    # -- two-stage geometric verification ------------------------------------

    def _verify(
        self,
        db: KeyframeDatabase,
        cand_id: int,
        edge_pb: PointBatch,
        surf_pb: PointBatch,
        init_pose,
    ):
        """rough → evaluate → refine → evaluate. Returns (pose, score,
        overlap) or None. ``init_pose`` is the map-frame initial guess of the
        query scan."""
        cfg = self.config
        with self.timer("loop_localmap"):
            # fixed-K device-resident assembly: static shapes, no per-query
            # cloud upload
            map_edge, map_surf = db.local_map_device(cand_id, cfg.adjacent_window)
        with self.timer("loop_verify"):
            out = _verify_fused(
                edge_pb, surf_pb, map_edge, map_surf,
                torch.as_tensor(np.asarray(init_pose, np.float32), device=db.device),
                cfg.rough_params, cfg.refine_params,
                cfg.rough_score_thresh, cfg.min_overlap,
            )
            pose, score, overlap, conv, ncon, rough_score = out
            packed = torch.cat([
                pose.to(torch.float32),
                torch.stack([score, overlap, conv.to(torch.float32),
                             ncon.to(torch.float32), rough_score]),
            ]).cpu().numpy()
        pose = packed[:7].astype(np.float32)
        score, overlap, conv, ncon, rough_score = (float(v) for v in packed[7:])
        if rough_score > cfg.rough_score_thresh:
            return None
        # a loop edge must be fully constrained: 6/6 eigendirections of JᵀJ
        # above the degeneracy floor AND a converged solve — a ground-plane-
        # only or corridor match (x/y/yaw free) can score well yet fix
        # nothing
        if not bool(conv) or int(ncon) < 6:
            return None
        if score > cfg.refine_score_thresh:
            return None
        return pose, score, overlap

    # -- public API -----------------------------------------------------------

    def detect(
        self,
        db: KeyframeDatabase,
        new_id: int,
        edge_pb: PointBatch,
        surf_pb: PointBatch,
    ) -> Optional[LoopResult]:
        """Try to close a loop for keyframe ``new_id`` (clouds in sensor
        frame). Returns a verified loop edge or None."""
        cfg = self.config
        if new_id - self._last_attempt < cfg.detect_spacing:
            return None
        self._last_attempt = new_id

        with self.timer("loop_search"):
            cand = self._sc_candidate(db, new_id, new_id)
        if cand is not None:
            # appearance candidate: init at the candidate pose rotated by the
            # scan-context yaw alignment
            cand_id, yaw = cand
            init = _yaw_init(db.map_poses[cand_id], yaw)
        else:
            cand = self._position_candidate(db, db.map_poses[new_id, 4:], new_id)
            if cand is None:
                return None
            cand_id, _ = cand
            # geometric candidate: keep the query's own odometry estimate
            # (drift assumed small at ≤ search_radius), z snapped to the
            # historical candidate
            init = db.map_poses[new_id].copy()
            init[6] = db.map_poses[cand_id][6]

        ver = self._verify(db, cand_id, edge_pb, surf_pb, init)
        if ver is None:
            # second try from the drifted odometry pose (covers the case
            # where drift is small but the appearance yaw/position prior is
            # wrong — e.g. a symmetric world aliasing the scan context)
            ver = self._verify(db, cand_id, edge_pb, surf_pb, db.map_poses[new_id])
        if ver is None:
            return None
        pose_new, score, overlap = ver
        # odometry-plausibility gate on the implied map-frame correction
        corr = np.linalg.norm(pose_new[4:] - db.map_poses[new_id][4:])
        if corr > cfg.max_correction_trans:
            return None
        z = np.asarray(se3np.pose_between(db.map_poses[cand_id], pose_new), np.float32)
        noise = self.edge_noise(score)
        return LoopResult(cand_id, new_id, z, noise, score, overlap)

    def edge_noise(self, score: float) -> np.ndarray:
        """Fitness-score → loop-edge noise (σ²): σ is interpolated from
        ``loop_info_best_scale``·σ_base at ``loop_score_best`` up to σ_base
        at the accept threshold."""
        cfg = self.config
        lo, hi = cfg.loop_score_best, max(cfg.refine_score_thresh, 1e-9)
        t = float(np.clip((score - lo) / max(hi - lo, 1e-9), 0.0, 1.0))
        s = cfg.loop_info_best_scale + t * (1.0 - cfg.loop_info_best_scale)
        base = np.array([cfg.loop_noise_rot] * 3 + [cfg.loop_noise_trans] * 3)
        return base * (s * s)

    def relocalize(
        self,
        db: KeyframeDatabase,
        edge_pb: PointBatch,
        surf_pb: PointBatch,
    ) -> Optional[RelocResult]:
        """Appearance-based global relocalization of a scan against the whole
        database: SC best match → two-stage registration vs its local map →
        accept at score ≤ ``reloc_score_thresh``."""
        cfg = self.config
        if db.n_keyframes == 0:
            return None
        both = PointBatch(
            torch.cat([edge_pb.xyz, surf_pb.xyz]),
            torch.cat([edge_pb.mask, surf_pb.mask]),
        )
        query_sc = scancontext.make_scan_context(
            both, rings=db.sc_shape[0], sectors=db.sc_shape[1]
        )
        sc_db, rk_db, valid = db.descriptor_arrays()
        best_id, dist, yaw = self._read_search(
            *scancontext.sc_search(query_sc, sc_db, rk_db, valid)
        )
        if best_id < 0 or dist > cfg.sc_dist_thresh:
            return None
        init = _yaw_init(db.map_poses[best_id], yaw)
        ver = self._verify(db, best_id, edge_pb, surf_pb, init)
        if ver is None:
            return None
        pose, score, overlap = ver
        if score > cfg.reloc_score_thresh:
            return None
        return RelocResult(pose, best_id, score, overlap)
