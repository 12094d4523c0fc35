"""Lifelong SLAM backend: RELOCALIZATION / LOCALIZATION / MAPPING mode FSM.

Counterpart of ``lmsf_slam_tpu/backend/lifelong.py``:

- work-mode FSM;
- boot with an existing database → RELOCALIZATION;
- relocalization on keyframe arrival: appearance match → on success set
  ``odom→map`` and switch to LOCALIZATION;
- LOCALIZATION: kNN search of the historical position mirror (k=10) →
  assemble a local map from those keyframes → scan-to-map registration →
  alignment evaluation, then the three-way gate: score>1 → lost →
  RELOCALIZATION; score≤0.04 with overlap in (0.5, 0.9) → **map update**:
  re-link the keyframe to the nearest node and switch to MAPPING (map
  extension while localizing); otherwise refresh ``odom→map``;
- MAPPING: append vertices + between edges, feed the loop detector, optimize
  on loop closure or every ``optimize_batch`` keyframes, write optimized
  poses back to the database, recompute ``odom→map``, and on a closed loop
  switch to LOCALIZATION (auto mapping→localization on revisit);
- timestamp-disorder guard at ingest;
- post-insertion hooks on every stored keyframe: the live 2D occupancy grid
  (rebuilt from the database when a loop closure moves the poses) and
  dynamic-object carving of the nearest stored keyframes with the new scan's
  free space; the unsupported-point gate on the map-extension branch;
- ``save`` / ``load``: a loaded database boots in RELOCALIZATION.

The FSM itself is tiny host logic in numpy (:mod:`..common.se3np`); every
arrow of it bottoms out in device work (registration, alignment evaluation,
descriptor search, batch pose-graph GN) on the database's device.

Not ported yet, raising ``NotImplementedError`` where it would run: the
submap Schur solve (``schur_submaps`` on a graph of ``schur_min_vertices`` or
more) — ROADMAP.md section 1, item 15.
"""
from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..common import se3, se3np
from ..common.pointcloud import PointBatch
from ..mapping.occupancy import (
    OccupancyConfig,
    keyframe_update,
    occupancy_from_database,
    occupancy_init,
)
from ..ops.dynamic import carve_dynamic, unsupported_mask
from ..ops.registration import RegistrationParams, register_and_score
from ..utils.profiling import StageTimer
from .keyframe_db import KeyframeDatabase
from .loop_closure import LoopConfig, LoopDetector
from .pose_graph import PoseGraphParams, optimize_pose_graph


class WorkMode(enum.Enum):
    RELOCALIZATION = 0
    LOCALIZATION = 1
    MAPPING = 2


class LifelongConfig(NamedTuple):
    localization_knn: int = 10  # historical nodes in the local map
    lost_score: float = 1.0  # localization-loss gate
    map_update_score: float = 0.04  # map-extension gate
    map_update_overlap_lo: float = 0.5
    map_update_overlap_hi: float = 0.9
    optimize_batch: int = 10  # max KFs per optimization cycle
    # windowed re-solve policy: between loop closures only the newest
    # ``optimize_window`` vertices are free (older ones act as a fixed
    # boundary / prior), so per-keyframe cost is flat in graph size; a loop
    # closure triggers a FULL solve. 0 disables (always full).
    optimize_window: int = 0
    # submap/Schur-partitioned FULL solve: when a full optimization covers at
    # least ``schur_min_vertices`` vertices, eliminate ``schur_submaps``
    # contiguous submaps with batched dense Cholesky instead of running the
    # replicated PCG. 0 keeps the replicated solve.
    schur_submaps: int = 0
    schur_min_vertices: int = 2048
    # floor on the padded vertex/edge capacity handed to the solver, so a
    # young graph keeps one set of shapes while it grows
    graph_pad_min: int = 512
    # padded vertex capacity of the *window-local* subgraph solve: windowed
    # re-solves extract only the free window + its fixed boundary vertices,
    # so per-keyframe optimization cost is O(window), independent of total
    # graph size
    window_pad_min: int = 128
    localization_params: RegistrationParams = RegistrationParams(
        max_iters=8, max_corr_dist=2.0
    )
    # overlap floor for the localization alignment evaluator; below this the
    # score saturates to the lost sentinel. Deliberately lower than the loop
    # verifier's 0.5: localization must keep reporting a usable score while
    # the map-update gate (overlap ∈ (0.5, 0.9)) decides on extension.
    localization_min_overlap: float = 0.1
    pose_graph: PoseGraphParams = PoseGraphParams()
    # odometry between-edge noise σ² [rot×3, trans×3]
    odom_noise_rot: float = 1e-4
    odom_noise_trans: float = 0.0025
    # GNSS absolute-position prior noise σ (m); keyframes carrying a GNSS
    # observation become unary anchors in the graph solve
    gnss_std: float = 0.1
    # plane/floor-constraint cadence: every Nth keyframe gets a unary factor
    # pinning z to ``plane_z`` and roll/pitch to plane-normal alignment —
    # kills the z/tilt drift that between-edges and position priors can't
    # observe indoors. 0 disables.
    plane_constraint_every: int = 0
    plane_z: float = 0.0
    plane_std_z: float = 0.1  # σ on height (m)
    plane_std_rp: float = 0.05  # σ on the tilt components of R·e_z
    # dynamic-object carving: every stored keyframe whose points the NEW scan
    # sees through gets those points masked out. k = how many nearest stored
    # keyframes each new scan carves (0 disables). Requires the System to
    # pass the scan's range image.
    dynamic_carve_knn: int = 0
    dynamic_carve_margin: float = 0.3  # beam must overshoot by this (m)
    # carving never touches points within this height of the ground; the
    # ground level is self-calibrated per scan as the 5th percentile of the
    # scan's own map-frame heights
    dynamic_carve_ground_clearance: float = 0.5
    # gate unsupported scan points when inserting a keyframe in LOCALIZATION
    # map-update
    dynamic_gate_unsupported: bool = False
    # live 2D occupancy grid, updated on every stored keyframe, rebuilt from
    # the database on loop closure. None disables.
    occupancy: Optional[OccupancyConfig] = None


class BackendOutput(NamedTuple):
    mode: WorkMode
    keyframe_id: int  # id in the database, -1 if not stored
    map_pose: np.ndarray  # (7,) current map-frame pose estimate
    odom2map: np.ndarray  # (7,) odom→map correction
    loop_closed: bool
    score: float  # localization / verification score (nan in pure mapping)
    overlap: float


def _pad_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class LifelongBackend:
    """Host-side FSM orchestrating the device work.

    ``add_keyframe(stamp, edge, surf, odom_pose)`` is the single entry point;
    clouds are in the sensor frame, ``odom_pose`` in the front-end odometry
    frame.
    """

    def __init__(
        self,
        db: Optional[KeyframeDatabase] = None,
        config: LifelongConfig = LifelongConfig(),
        loop_config: LoopConfig = LoopConfig(),
        mode: Optional[WorkMode] = None,
        device="cuda",
    ):
        """``device`` places the database this constructor makes when ``db``
        is None; a given database brings its own."""
        self.db = db if db is not None else KeyframeDatabase(device=device)
        self.config = config
        # per-stage wall-clock aggregation, shared with the loop detector,
        # read via ``timer.stats()``
        self.timer = StageTimer()
        self.loop_detector = LoopDetector(loop_config, timer=self.timer)
        # per-keyframe decision log (mode, kf_id, score, overlap, loop)
        self.history: list[BackendOutput] = []
        # which solver ran how often
        self.solver_runs = {"full_schur": 0, "full_replicated": 0, "windowed": 0}
        # every solve so far: kind, vertices, GN iterations, chi2 before/after
        self.solve_log: list[dict] = []
        # boot semantics: empty DB → MAPPING; loaded DB → RELOCALIZATION
        if mode is None:
            mode = WorkMode.RELOCALIZATION if self.db.n_keyframes > 0 else WorkMode.MAPPING
        self.mode = mode
        self.odom2map = np.asarray(se3np.pose_identity(), np.float32)
        self.last_stamp = -np.inf
        self._pending = 0  # keyframes appended since last optimize
        self._occ = (
            occupancy_init(config.occupancy, self.db.device) if config.occupancy else None
        )
        if self._occ is not None and self.db.n_keyframes > 0:
            # booting from an existing database: synchronize the grid
            self._occ = occupancy_from_database(self.db, config.occupancy)

    # -- helpers --------------------------------------------------------------

    def _map_pose(self, odom_pose) -> np.ndarray:
        # host pose math (se3np): single-pose bookkeeping launches nothing
        return np.asarray(se3np.pose_compose(self.odom2map, odom_pose), np.float32)

    def _set_odom2map(self, map_pose, odom_pose):
        self.odom2map = np.asarray(
            se3np.pose_compose(map_pose, se3np.pose_inverse(odom_pose)), np.float32
        )

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.db.device)

    def _knn_local_map(self, position: np.ndarray):
        """Local map from the k nearest historical keyframes — kNN over the
        resident position mirror feeding the fixed-K cloud gather (ids never
        leave the device)."""
        return self.db.local_map_knn_device(position, self.config.localization_knn)

    def _on_keyframe_stored(self, kf_id: int, scan_grid=None):
        """Post-insertion hooks: live occupancy update + dynamic carving."""
        cfg = self.config
        carving = cfg.dynamic_carve_knn > 0 and scan_grid is not None
        if self._occ is None and not carving:
            return
        pose = self._tensor(self.db.map_poses[kf_id])
        if self._occ is not None:
            edge, surf = self.db.keyframe_clouds(kf_id)
            self._occ = keyframe_update(
                self._occ, pose, torch.cat([edge.xyz, surf.xyz]),
                torch.cat([edge.mask, surf.mask]), cfg.occupancy,
            )
        if carving:
            # carve the k nearest STORED keyframes with the new scan's
            # free space (new structure is untouched: carving only fires
            # where the beam measured a LONGER range than the stored point)
            ids, _ = self.db.nearest_ids(
                self.db.map_poses[kf_id, 4:], cfg.dynamic_carve_knn, max_id=kf_id,
            )
            # ONE copy of the range image to the host: its points, their
            # map-frame heights and the mask; the limits are host numpy
            flat = scan_grid.xyz.reshape(-1, 3).to(torch.float32)
            gz_d = se3.pose_apply(pose, flat)[:, 2]
            packed = torch.cat(
                [flat.reshape(-1), gz_d, scan_grid.mask.reshape(-1).to(torch.float32)]
            ).cpu().numpy()
            n = flat.shape[0]
            xyz, gz, gm = packed[: 3 * n].reshape(n, 3), packed[3 * n: 4 * n], packed[4 * n:] > 0
            if not gm.any():
                return
            elev = np.arctan2(xyz[:, 2], np.maximum(np.linalg.norm(xyz[:, :2], axis=-1), 1e-6))
            elev_min = float(elev[gm].min())
            elev_max = float(elev[gm].max())
            # self-calibrated ground level: 5th percentile of the scan's own
            # map-frame heights + clearance
            z_min = float(np.percentile(gz[gm], 5.0)) + cfg.dynamic_carve_ground_clearance
            keeps = []
            for j in ids:
                j = int(j)
                edge_j, surf_j = self.db.keyframe_clouds(j)
                pose_j = self._tensor(self.db.map_poses[j])
                both = PointBatch(
                    se3.pose_apply(pose_j, torch.cat([edge_j.xyz, surf_j.xyz])),
                    torch.cat([edge_j.mask, surf_j.mask]),
                )
                keeps.append(carve_dynamic(
                    scan_grid, both, pose,
                    elev_min=elev_min, elev_max=elev_max,
                    margin=cfg.dynamic_carve_margin, z_min=z_min,
                ))
            if not keeps:
                return
            keeps = torch.stack(keeps).cpu().numpy()  # one copy for all k
            ne = self.db.edge_capacity
            for j, keep in zip(ids, keeps):
                self.db.carve(int(j), keep[:ne], keep[ne:])

    def occupancy_grid(self) -> Optional[torch.Tensor]:
        """Current synchronized 2D log-odds grid (None if disabled)."""
        return self._occ

    # -- FSM arrows -----------------------------------------------------------

    def _do_relocalization(self, stamp, edge, surf, odom_pose) -> BackendOutput:
        res = self.loop_detector.relocalize(self.db, edge, surf)
        if res is None:
            return BackendOutput(
                self.mode, -1, self._map_pose(odom_pose), self.odom2map, False, np.nan, 0.0,
            )
        self._set_odom2map(res.pose, odom_pose)
        self.mode = WorkMode.LOCALIZATION
        return BackendOutput(
            self.mode, -1, res.pose, self.odom2map, False, res.score, res.overlap
        )

    def _do_localization(self, stamp, edge, surf, odom_pose, scan_grid=None) -> BackendOutput:
        cfg = self.config
        pred_np = self._map_pose(odom_pose)
        with self.timer("loc_localmap"):
            map_edge, map_surf = self._knn_local_map(pred_np[4:])
        with self.timer("loc_register"):
            # registration + alignment evaluation, one packed copy to the host
            reg, score_d, overlap_d = register_and_score(
                edge, surf, map_edge, map_surf, self._tensor(pred_np),
                cfg.localization_params,
                min_overlap=cfg.localization_min_overlap,
            )
            packed = torch.cat([
                reg.pose.to(torch.float32), torch.stack([score_d, overlap_d]),
            ]).cpu().numpy()
            pose_np = packed[:7].astype(np.float32)
            score, overlap = float(packed[7]), float(packed[8])

        if score > cfg.lost_score:
            # localization lost
            self.mode = WorkMode.RELOCALIZATION
            return BackendOutput(self.mode, -1, pose_np, self.odom2map, False, score, overlap)

        if (
            score <= cfg.map_update_score
            and cfg.map_update_overlap_lo < overlap < cfg.map_update_overlap_hi
        ):
            # map extension: store the keyframe, link to the nearest node,
            # switch to MAPPING
            map_pose = pose_np
            if cfg.dynamic_gate_unsupported:
                # entering a mapped region: scan points with no map support
                # are transients — keep them out of the stored keyframe
                map_all = PointBatch(
                    torch.cat([map_edge.xyz, map_surf.xyz]),
                    torch.cat([map_edge.mask, map_surf.mask]),
                )
                pose_d = self._tensor(map_pose)
                edge = PointBatch(
                    edge.xyz, edge.mask & ~unsupported_mask(edge, map_all, pose_d), edge.attr,
                )
                surf = PointBatch(
                    surf.xyz, surf.mask & ~unsupported_mask(surf, map_all, pose_d), surf.attr,
                )
            kf_id = self.db.add_keyframe(stamp, odom_pose, map_pose, edge, surf)
            nn_ids, _ = self.db.nearest_ids(map_pose[4:], 1, max_id=kf_id)
            nearest = int(nn_ids[0])
            z = se3np.pose_between(self.db.map_poses[nearest], map_pose)
            self.db.add_edge(
                nearest, kf_id, z,
                np.array([cfg.odom_noise_rot] * 3 + [cfg.odom_noise_trans] * 3),
            )
            self._pending += 1
            self._on_keyframe_stored(kf_id, scan_grid)
            self._set_odom2map(map_pose, odom_pose)
            self.mode = WorkMode.MAPPING
            return BackendOutput(self.mode, kf_id, map_pose, self.odom2map, False, score, overlap)

        # healthy localization: refresh odom→map
        self._set_odom2map(pose_np, odom_pose)
        return BackendOutput(self.mode, -1, pose_np, self.odom2map, False, score, overlap)

    def _do_mapping(
        self, stamp, edge, surf, odom_pose, gnss_pos=None, scan_grid=None
    ) -> BackendOutput:
        cfg = self.config
        map_pose = self._map_pose(odom_pose)
        with self.timer("kf_insert"):
            kf_id = self.db.add_keyframe(
                stamp, odom_pose, map_pose, edge, surf, gnss_pos=gnss_pos
            )
        if kf_id > 0:
            z = se3np.pose_between(self.db.map_poses[kf_id - 1], map_pose)
            self.db.add_edge(
                kf_id - 1, kf_id, z,
                np.array([cfg.odom_noise_rot] * 3 + [cfg.odom_noise_trans] * 3),
            )
        self._pending += 1
        with self.timer("kf_hooks"):
            self._on_keyframe_stored(kf_id, scan_grid)

        with self.timer("loop_detect"):
            loop = self.loop_detector.detect(self.db, kf_id, edge, surf)
        loop_closed = loop is not None
        if loop_closed:
            self.db.add_edge(loop.from_id, loop.to_id, loop.z, loop.noise, loop=True)

        if loop_closed or self._pending >= cfg.optimize_batch:
            with self.timer("optimize_full" if loop_closed else "optimize_win"):
                self.optimize(full=loop_closed)
            self._pending = 0
            map_pose = self.db.map_poses[kf_id].copy()
            self._set_odom2map(map_pose, odom_pose)
            if loop_closed:
                # revisiting mapped area → auto-switch to localization
                self.mode = WorkMode.LOCALIZATION
                if self._occ is not None:
                    # graph poses moved: rebuild the synchronized grid
                    with self.timer("occ_rebuild"):
                        self._occ = occupancy_from_database(self.db, cfg.occupancy)
        return BackendOutput(
            self.mode, kf_id, np.asarray(map_pose), self.odom2map, loop_closed, np.nan, np.nan,
        )

    # -- public API -------------------------------------------------------------

    def add_keyframe(
        self, stamp: float, edge: PointBatch, surf: PointBatch, odom_pose,
        gnss_pos=None, scan_grid=None,
    ) -> BackendOutput:
        """``gnss_pos``: optional (3,) absolute position observation (map/ENU
        frame) attached to this keyframe as a graph prior. ``scan_grid``:
        optional organized range image of the keyframe's scan (sensor frame),
        the input of dynamic-object carving."""
        if stamp < self.last_stamp:
            # timestamp disorder guard: drop the keyframe
            return BackendOutput(
                self.mode, -1, self._map_pose(odom_pose), self.odom2map, False, np.nan, np.nan,
            )
        self.last_stamp = stamp
        odom_pose = np.asarray(odom_pose, np.float32)
        if self.mode is WorkMode.RELOCALIZATION:
            out = self._do_relocalization(stamp, edge, surf, odom_pose)
        elif self.mode is WorkMode.LOCALIZATION:
            out = self._do_localization(stamp, edge, surf, odom_pose, scan_grid=scan_grid)
        else:
            out = self._do_mapping(
                stamp, edge, surf, odom_pose, gnss_pos=gnss_pos, scan_grid=scan_grid
            )
        self.history.append(out)
        return out

    def _unary_priors(self, gnss_ids, plane_ids, lut=None) -> dict:
        """The GNSS position priors and plane factors of a solve, padded to
        powers of two. ``lut`` maps database ids to the solve's vertex ids
        (identity when None)."""
        cfg = self.config
        local = (lambda ids: ids) if lut is None else (lambda ids: lut[ids])
        priors = {}
        if gnss_ids.size > 0:
            K = _pad_pow2(gnss_ids.size)
            pidx = np.zeros(K, np.int32)
            pxyz = np.zeros((K, 3), np.float32)
            pmask = np.zeros(K, bool)
            pidx[: gnss_ids.size] = local(gnss_ids)
            pxyz[: gnss_ids.size] = self.db.gnss_pos[gnss_ids]
            pmask[: gnss_ids.size] = True
            priors.update(
                prior_xyz=self._tensor(pxyz),
                prior_idx=self._tensor(pidx),
                prior_sqrtw=self._tensor(np.full((K, 3), 1.0 / cfg.gnss_std, np.float32)),
                prior_mask=self._tensor(pmask),
            )
        if plane_ids is not None:
            K = _pad_pow2(plane_ids.size)
            pl_idx = np.zeros(K, np.int32)
            pl_mask = np.zeros(K, bool)
            pl_idx[: plane_ids.size] = local(plane_ids)
            pl_mask[: plane_ids.size] = True
            sw = np.array([1.0 / cfg.plane_std_z] + [1.0 / cfg.plane_std_rp] * 2, np.float32)
            priors.update(
                plane_idx=self._tensor(pl_idx),
                plane_z=self._tensor(np.full(K, cfg.plane_z, np.float32)),
                plane_sqrtw=self._tensor(np.broadcast_to(sw, (K, 3)).copy()),
                plane_mask=self._tensor(pl_mask),
            )
        return priors

    def optimize(self, full: bool = True):
        """Batch GN; write poses back. With ``optimize_window`` set and
        ``full=False`` only the newest window of vertices is free
        (warm-started windowed re-solve); loop closures call with
        ``full=True``."""
        cfg = self.config
        n = self.db.n_keyframes
        if self.db.n_edges == 0 or n < 2:
            return None
        w = cfg.optimize_window
        if not full and w > 0 and n > w + 1:
            self.solver_runs["windowed"] += 1
            return self._optimize_window(w)
        g = self.db.graph_arrays(pad_min=cfg.graph_pad_min)
        fixed = None
        gnss_ids = np.nonzero(self.db.gnss_valid[:n])[0]
        if gnss_ids.size > 0:
            # absolute priors provide the gauge — pinning vertex 0 as well
            # would fight them whenever keyframe 0's map pose disagrees with
            # the GNSS fixes, so free every vertex
            fixed = torch.zeros(g.poses.shape[0], dtype=torch.bool, device=self.db.device)
        cad = cfg.plane_constraint_every
        plane_ids = np.arange(0, n, cad, dtype=np.int64) if cad > 0 else None
        priors = self._unary_priors(gnss_ids, plane_ids)
        if full and cfg.schur_submaps > 0 and n >= cfg.schur_min_vertices:
            raise NotImplementedError(
                "the submap Schur solve (schur_submaps > 0 on a graph of "
                "schur_min_vertices or more) is not ported yet (ROADMAP.md "
                "section 1, item 15)"
            )
        self.solver_runs["full_replicated"] += 1
        poses, stats = optimize_pose_graph(
            g.poses, g.vmask, g.edges_ij, g.edges_z, g.edges_sqrtw, g.emask,
            fixed=fixed,
            edges_robust=g.erobust,
            params=cfg.pose_graph,
            **priors,
        )
        self.db.update_poses(poses.cpu().numpy())
        self._log_solve("full_replicated", n, stats)
        return stats

    def _optimize_window(self, w: int):
        """Window-local incremental re-solve — cost O(window), not O(graph).

        Extract the subgraph of the newest ``w`` vertices plus the fixed
        boundary vertices their edges reach (the chain predecessor + any
        loop-edge anchors), pad it to a *constant* capacity
        (``window_pad_min``), and run the same batched GN/PCG on that. Older
        vertices act as the fixed linearization boundary; loop closures
        still trigger full solves in ``optimize``.
        """
        db = self.db
        n = db.n_keyframes
        base = n - w
        ne = db.n_edges
        eij = db.eij[:ne]
        sel = np.nonzero((eij[:, 0] >= base) | (eij[:, 1] >= base))[0]
        ends = eij[sel]
        old_ids = np.unique(ends[ends < base])
        n_old = int(old_ids.size)
        gids = np.concatenate([old_ids.astype(np.int64), np.arange(base, n)]).astype(np.int32)
        V = int(gids.size)
        E = int(sel.size)
        lut = np.zeros(n, np.int32)
        lut[gids] = np.arange(V, dtype=np.int32)
        pad = self.config.window_pad_min
        Vp = max(_pad_pow2(V), pad)
        Ep = max(_pad_pow2(E), pad * 2)
        poses = np.zeros((Vp, 7), np.float32)
        poses[:, 0] = 1.0
        poses[:V] = db.map_poses[gids]
        vmask = np.zeros(Vp, bool)
        vmask[:V] = True
        # boundary vertices are the gauge; a window with no boundary cannot
        # occur (the chain edge base-1→base always selects base-1)
        fixed = np.ones(Vp, bool)
        fixed[n_old:V] = False
        eijp = np.zeros((Ep, 2), np.int32)
        ez = np.zeros((Ep, 7), np.float32)
        ez[:, 0] = 1.0
        esw = np.zeros((Ep, 6), np.float32)
        emask = np.zeros(Ep, bool)
        erob = np.zeros(Ep, bool)
        eijp[:E] = lut[ends]
        ez[:E] = db.ez[sel]
        esw[:E] = db.esqrtw[sel]
        emask[:E] = True
        erob[:E] = db.eloop[sel]
        gnss_ids = np.nonzero(db.gnss_valid[base:n])[0] + base
        cad = self.config.plane_constraint_every
        plane_ids = None
        if cad > 0:
            plane_ids = np.arange(0, n, cad, dtype=np.int64)
            plane_ids = plane_ids[plane_ids >= base]
        priors = self._unary_priors(gnss_ids, plane_ids, lut)
        opt, stats = optimize_pose_graph(
            *(self._tensor(a) for a in (poses, vmask, eijp, ez, esw, emask)),
            fixed=self._tensor(fixed),
            edges_robust=self._tensor(erob),
            params=self.config.pose_graph,
            **priors,
        )
        db.update_poses_range(base, opt.cpu().numpy()[n_old:V])
        self._log_solve("windowed", V, stats)
        return stats

    def _log_solve(self, kind: str, vertices: int, stats) -> None:
        """Keep what the solve just run reported (one small copy to the host,
        after the poses' own): ``solve_log[-1]`` is the last solve."""
        chi2_0, chi2_1, iters = torch.stack([
            stats.chi2_initial.to(torch.float64), stats.chi2_final.to(torch.float64),
            stats.iterations.to(torch.float64),
        ]).cpu().tolist()
        self.solve_log.append({
            "kind": kind, "keyframes": int(self.db.n_keyframes), "vertices": int(vertices),
            "iterations": int(iters), "chi2_initial": chi2_0, "chi2_final": chi2_1,
        })

    def force_global_optimize(self):
        """A full solve on demand."""
        return self.optimize()

    def save(self, path: str):
        self.db.save(path)

    @classmethod
    def load(cls, path: str, storage_dir: str | None = None, device="cuda",
             **kwargs) -> "LifelongBackend":
        """Boot from an existing database → RELOCALIZATION mode, the database
        (and so the backend's work) on ``device``. ``storage_dir`` is
        forwarded to :meth:`KeyframeDatabase.load` for disk-backed
        checkpoints (default: a fresh session directory next to ``path``)."""
        db = KeyframeDatabase.load(path, storage_dir=storage_dir, device=device)
        return cls(db=db, **kwargs)
