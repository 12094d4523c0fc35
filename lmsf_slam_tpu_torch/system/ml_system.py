"""System orchestration: raw scans in → trajectory + lifelong map out.

Counterpart of ``lmsf_slam_tpu/system/ml_system.py``. Every frame takes one
path, for one LiDAR or several, with or without an IMU: the featurize half
(:func:`build_featurize`: ``preprocess`` → ``organize_scan`` →
``extract_loam_features``) on each LiDAR's scan, the sub scans' features
moved into the primary's frame (or the primary's alone, padded to the fused
capacity, while the extrinsics are calibrated), then ``tracker_step``, or
under ``use_imu`` :class:`..lio.LioTracker` (ESKF propagation over the IMU
window, deskew, registration with the IMU prediction, the filter's
correction), and ONE read-back of the frame's pose. With
``registration_method="sparse_point_plane_icp"`` the features are the
preprocessed scan voxel-downsampled at ``icp_voxel_size`` into the surf
capacity, with no edges (point-to-plane ICP against the local map). With
several LiDARs the sub scans' extrinsics are calibrated online in three
phases (hand-eye from per-LiDAR odometry, refinement against the primary's
local map, then fused tracking of every LiDAR's features moved into the
primary's frame), or given as ``extrinsics``. GNSS fixes fuse into the
filter through :meth:`MultiLidarSystem.process_gnss` and ride the next
keyframe as a graph prior. Then the host-side :class:`KeyframeGate` on the
pose read back, the hand-off of keyframes to the lifelong backend (mapping,
localization, loop closure, relocalization) either inline or, with
``async_backend``, through the worker thread of
:class:`..backend.async_backend.AsyncBackend`, and a :class:`FrameResult`
every frame (:class:`MultiLidarSystem`), with ``save`` / ``load`` of the
lifelong database.

``SystemConfig`` carries every field of the reference's, so configurations
move between the packages unchanged.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..backend.keyframe_db import KeyframeDatabase
from ..backend.lifelong import BackendOutput, LifelongBackend, LifelongConfig, WorkMode
from ..backend.loop_closure import LoopConfig
from ..calibration.handeye import (
    HandEyeConfig,
    handeye_add_pair,
    handeye_init,
    handeye_solve,
)
from ..common import se3np
from ..estimator.eskf import eskf_update_position
from ..estimator.gnss import lla_to_enu, make_enu_frame
from ..lio.lio_tracker import LioConfig, LioTracker
from ..common.pointcloud import PointBatch, concat as pb_concat
from ..ops import features as F
from ..ops.preprocess import PreprocessParams, preprocess
from ..ops.registration import RegistrationParams, register_edge_surf
from ..ops.voxel import voxel_downsample
from ..tracker.tracker import TrackerConfig, tracker_init, tracker_step


class FeatureParams(NamedTuple):
    """Range-image + LOAM feature extraction configuration.

    Output capacities are static: edges = rings·sectors·edges_per_sector,
    surfs = rings·sectors·surfs_per_sector.
    """

    rings: int = 16
    width: int = 900
    sectors: int = 6
    edges_per_sector: int = 4
    surfs_per_sector: int = 16
    edge_thresh: float = 0.5
    surf_thresh: float = 0.05
    nms_half: int = 5
    # sensor range noise σ (m): noise-floor-compensated edge curvature
    range_noise: float = 0.0
    # bar ground cells from the edge channel
    exclude_ground_edges: bool = False
    # reject only the background side of a silhouette
    one_sided_occlusion: bool = False

    @property
    def edge_capacity(self) -> int:
        return self.rings * self.sectors * self.edges_per_sector

    @property
    def surf_capacity(self) -> int:
        return self.rings * self.sectors * self.surfs_per_sector


class SystemConfig(NamedTuple):
    n_lidars: int = 1
    feature: FeatureParams = FeatureParams()
    preprocess: PreprocessParams = PreprocessParams()
    # front-end matching method: "feature_based" = LOAM edge+surf GN;
    # "sparse_point_plane_icp" = voxel-downsampled whole cloud as planar
    # points, no edge classification
    registration_method: str = "feature_based"
    icp_voxel_size: float = 0.4  # scan downsample for the ICP method
    # multi-lidar online extrinsic calibration: phase 0 = per-lidar odometry
    # + hand-eye init; phase 1 = refinement of each sub extrinsic against the
    # primary local map; phase 2 = fused tracking of all lidars in the
    # primary frame
    handeye: HandEyeConfig = HandEyeConfig(min_pairs=10)
    calib_refine_frames: int = 5  # accepted refinements before phase 2
    # phase-1 refinement registration: longer leash than tracking and a
    # degeneracy floor scaled to a single sub scan's match count
    calib_refine_registration: RegistrationParams = RegistrationParams(
        max_iters=16, max_corr_dist=2.0, degen_thresh=25.0
    )
    # known extrinsics (list of (7,) poses of lidar i in lidar-0 frame) skip
    # calibration entirely; None → calibrate online
    extrinsics: Optional[tuple] = None
    # run the backend (loop detection + optimization) on a worker thread so
    # the frontend never stalls. async_policy: backpressure behavior when
    # the worker falls behind — "coalesce", "block" or "drop"
    async_backend: bool = False
    async_policy: str = "coalesce"
    # IMU-aided mode: ESKF-propagated prediction + sweep deskew; ``process``
    # then accepts per-frame IMU windows, and GNSS fixes fuse into the
    # filter via ``process_gnss``
    use_imu: bool = False
    # tracker (capacities derived from ``feature``)
    tracker_window: int = 20
    # IMU-free constant-velocity sweep deskew in the tracker (consumes the
    # per-point rel-time attr when present)
    deskew: bool = False
    # frontend dynamic-object probation gate: admit scan points to the
    # odometry local map only when map-supported or re-sighted at a static
    # world position (also turns on map carving)
    dynamic_probation: bool = False
    registration: RegistrationParams = RegistrationParams()
    map_update_trans: float = 0.3  # local-map insertion gate
    map_update_rot: float = 0.1
    map_update_dt: float = 10.0
    # backend keyframe gate
    keyframe_trans: float = 1.0  # m
    keyframe_rot: float = math.radians(30.0)
    keyframe_dt: float = 60.0  # s
    lifelong: LifelongConfig = LifelongConfig()
    loop: LoopConfig = LoopConfig()


class FrameResult(NamedTuple):
    timestamp: float
    odom_pose: np.ndarray  # (7,) front-end odometry-frame pose
    map_pose: np.ndarray  # (7,) map-frame pose (odom2map ∘ odom)
    mode: WorkMode
    is_keyframe: bool
    keyframe_id: int  # backend DB id, -1 if not stored
    loop_closed: bool
    converged: bool  # front-end registration health
    num_matches: int
    calib_status: int = 2  # 0 = hand-eye init, 1 = refining, 2 = calibrated


def _average_poses(samples: list) -> np.ndarray:
    """Robust average of clustered (7,) poses: sign-aligned quaternion mean
    + component-wise MEDIAN translation — individual refinement samples
    occasionally land decimeters off (scan-dependent minima), and the median
    shrugs those off where a mean would drag."""
    qs = np.stack([s[:4] for s in samples])
    qs = np.where((qs @ qs[0])[:, None] < 0, -qs, qs)
    q = qs.mean(axis=0)
    q = q / max(np.linalg.norm(q), 1e-12)
    t = np.median(np.stack([s[4:] for s in samples]), axis=0)
    return np.concatenate([q, t]).astype(np.float32)


class KeyframeGate:
    """Pass a frame to the backend when motion since the last keyframe
    exceeds trans/rot thresholds or the time gap exceeds ``dt``. Also tracks
    the accumulated travelled distance. Host numpy (se3np): it runs every
    frame and launches nothing on the card."""

    def __init__(self, trans: float, rot: float, dt: float):
        self.trans = trans
        self.rot = rot
        self.dt = dt
        self.last_pose: Optional[np.ndarray] = None
        self.last_stamp = -np.inf
        self.accum_distance = 0.0

    def need_update(self, pose: np.ndarray, stamp: float) -> bool:
        if self.last_pose is None:
            self.last_pose = np.asarray(pose, np.float32)
            self.last_stamp = stamp
            return True
        delta = se3np.pose_between(self.last_pose, pose)
        dx = float(np.linalg.norm(se3np.pose_trans(delta)))
        dr = float(np.linalg.norm(se3np.so3_log(se3np.pose_quat(delta))))
        if dx > self.trans or dr > self.rot or (stamp - self.last_stamp) > self.dt:
            self.accum_distance += dx
            self.last_pose = np.asarray(pose, np.float32)
            self.last_stamp = stamp
            return True
        return False


def tracker_config_for(config: SystemConfig) -> TrackerConfig:
    """The tracker configuration the system derives from its own (sized for
    the fused feature stream of ``n_lidars``)."""
    f = config.feature
    n = config.n_lidars
    return TrackerConfig(
        window=config.tracker_window,
        edge_capacity=n * f.edge_capacity,
        surf_capacity=n * f.surf_capacity,
        map_update_trans=config.map_update_trans,
        map_update_rot=config.map_update_rot,
        map_update_dt=config.map_update_dt,
        registration=config.registration,
        # under use_imu the LIO layer deskews before tracker_step
        deskew=config.deskew and not config.use_imu,
        probation=config.dynamic_probation,
        carve_map=config.dynamic_probation,
    )


def build_featurize(config: SystemConfig = SystemConfig(), device="cuda",
                    organize: Optional[bool] = None):
    """The featurize half of the per-frame step: ``featurize(xyz, mask,
    attr)`` runs preprocess → organize → LOAM features on ``device`` and
    returns ``(edge, surf, grid)`` in the sensor frame (the grid is the
    scan's range image, for carving). It launches work and reads nothing
    back. :class:`MultiLidarSystem` runs it on each LiDAR's scan a frame.

    With ``registration_method="sparse_point_plane_icp"`` the surf cloud is
    the preprocessed scan voxel-downsampled at ``icp_voxel_size`` into the
    surf capacity, the edges are empty, and the range image is organized only
    when ``organize`` (default: the backend carves, ``dynamic_carve_knn >
    0``); else the grid is None, as in the reference."""
    f = config.feature
    device = torch.device(device)
    icp = config.registration_method == "sparse_point_plane_icp"
    if organize is None:
        organize = config.lifelong.dynamic_carve_knn > 0

    def featurize(xyz, mask, attr):
        pb = PointBatch(
            torch.as_tensor(xyz, dtype=torch.float32, device=device),
            torch.as_tensor(mask, dtype=torch.bool, device=device),
            torch.as_tensor(attr, dtype=torch.float32, device=device),
        )
        processed = preprocess(pb, config.preprocess)
        if icp:
            surf = voxel_downsample(processed, config.icp_voxel_size, f.surf_capacity)
            grid = F.organize_scan(processed, rings=f.rings, width=f.width) if organize else None
            return PointBatch.empty(f.edge_capacity, device=device), surf, grid
        grid = F.organize_scan(processed, rings=f.rings, width=f.width)
        feats = F.extract_loam_features(
            grid,
            sectors=f.sectors,
            edges_per_sector=f.edges_per_sector,
            surfs_per_sector=f.surfs_per_sector,
            edge_thresh=f.edge_thresh,
            surf_thresh=f.surf_thresh,
            nms_half=f.nms_half,
            range_noise=f.range_noise,
            exclude_ground_edges=f.exclude_ground_edges,
            one_sided_occlusion=f.one_sided_occlusion,
        )
        return feats.edge, feats.surf, grid

    return featurize


def _read_back(out):
    """ONE device-to-host copy of a frame's pose, convergence flag and match
    count: (odom_pose (7,) float32, converged, num_matches)."""
    reg = out.registration
    packed = torch.cat([
        out.pose.to(torch.float32),
        reg.converged.to(torch.float32).reshape(1),
        reg.num_matches.to(torch.float32).reshape(1),
    ]).cpu().numpy()
    return packed[:7].astype(np.float32), bool(packed[7]), int(packed[8])


class MultiLidarSystem:
    """Public end-to-end SLAM system for one LiDAR or several, with or
    without an IMU.

    ``process(scan, timestamp)`` is the single entry point: a raw organized
    or unorganized scan (or one a LiDAR, primary first) goes in; the front
    end featurizes and tracks it; frames passing the keyframe gate feed the
    lifelong backend (mapping, localization, loop closure, relocalization); a
    ``FrameResult`` comes out every frame.
    """

    def __init__(
        self,
        config: SystemConfig = SystemConfig(),
        backend: Optional[LifelongBackend] = None,
        device="cuda",
    ):
        """``device`` is where the frame and a backend made here run; a given
        ``backend`` must keep its database on the same device."""
        self.config = config
        self.device = torch.device(device)
        f = config.feature
        n = config.n_lidars
        # the main tracker is sized for the FUSED feature stream (n lidars);
        # during calibration only the primary's slice is populated
        self.tracker_config = tracker_config_for(config)
        self.tracker_state = tracker_init(self.tracker_config, self.device)
        self._enu = None  # local ENU frame, anchored by the first GNSS fix
        if backend is not None:
            if backend.db.device.type != self.device.type:
                raise ValueError(
                    f"the backend's database is on {backend.db.device}, the system on {self.device}"
                )
            self.backend = backend
        else:
            db = KeyframeDatabase(
                edge_capacity=n * f.edge_capacity, surf_capacity=n * f.surf_capacity,
                device=self.device,
            )
            self.backend = LifelongBackend(db=db, config=config.lifelong, loop_config=config.loop)
        # the frame's spans go where the backend's stages and the worker's go
        self.timer = self.backend.timer
        self._lio = None
        if config.use_imu:
            # under IMU the per-frame prediction is physically grounded, so
            # the prediction-trust gate is safe and necessary: a coherent
            # mover drags the registration while the IMU knows better —
            # reject the dragged solve, coast on the propagated pose
            self._lio = LioTracker(
                LioConfig(tracker=self.tracker_config._replace(pred_trust_k=0.3)), self.device,
                timer=self.timer)
        self._async = None
        if config.async_backend:
            from ..backend.async_backend import AsyncBackend

            self._async = AsyncBackend(self.backend, policy=config.async_policy)
        # the ICP features organize a range image only for the backend's carving
        self._featurize = build_featurize(config, self.device,
                                          self.backend.config.dynamic_carve_knn > 0)
        self._pending_gnss = None  # latest ENU fix, attached to the next keyframe
        self.gate = KeyframeGate(config.keyframe_trans, config.keyframe_rot, config.keyframe_dt)
        self.results: list[FrameResult] = []

        # -- multi-lidar calibration state (the 3-phase FSM)
        if config.extrinsics is not None:
            if len(config.extrinsics) != n - 1:
                raise ValueError(f"{n} LiDARs need {n - 1} extrinsics, "
                                 f"got {len(config.extrinsics)}")
            self.extrinsics = [np.asarray(e, np.float32) for e in config.extrinsics]
            self.calib_status = 2
        elif n == 1:
            self.extrinsics = []
            self.calib_status = 2
        else:
            self.extrinsics = [None] * (n - 1)
            self.calib_status = 0
        if n > 1 and self.calib_status == 0:
            self._sub_config = TrackerConfig(
                window=config.tracker_window,
                edge_capacity=f.edge_capacity,
                surf_capacity=f.surf_capacity,
                map_update_trans=config.map_update_trans,
                map_update_rot=config.map_update_rot,
                map_update_dt=config.map_update_dt,
                registration=config.registration,
            )
            self._sub_trackers = [tracker_init(self._sub_config, self.device)
                                  for _ in range(n - 1)]
            self._handeye = [handeye_init(config.handeye, self.device) for _ in range(n - 1)]
            # motion anchors: (primary_pose, sub_pose) at the last sampled pair
            self._anchors = [None] * (n - 1)
            self._refine_ok = [0] * (n - 1)
            self._refine_samples = [[] for _ in range(n - 1)]

    # -- per-frame pipeline ---------------------------------------------------

    def featurize(self, scan: PointBatch):
        """Raw scan → (edge, surf, range-image grid) in the sensor frame, on
        the system's device (the grid rides along so the backend can carve
        dynamic points with the scan's free space)."""
        return self._featurize(scan.xyz, scan.mask, scan.attr)

    def _pad_to_fused(self, edge: PointBatch, surf: PointBatch):
        """Pad single-lidar features to the fused tracker capacity."""
        n = self.config.n_lidars
        if n == 1:
            return edge, surf
        f = self.config.feature
        return (
            pb_concat([edge], capacity=n * f.edge_capacity),
            pb_concat([surf], capacity=n * f.surf_capacity),
        )

    def _pose_tensor(self, pose) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pose, np.float32), device=self.device)

    def _calibration_step(self, feats, pose_p: np.ndarray, timestamp: float):
        """Phases 0/1 of the extrinsic FSM. Runs AFTER the primary tracker
        step, so ``pose_p`` is the current-frame primary pose — sub scans and
        the primary pose must be time-aligned for hand-eye increments. Pose
        bookkeeping is host numpy (se3np); a sub tracker's pose, a hand-eye
        solve (its ``eigh``, ``solve`` and ``ok``) and a refinement's result
        each wait for the card."""
        cfg = self.config
        for i, (se_, ss_, _) in enumerate(feats[1:]):
            if self.calib_status == 0:
                # phase 0: independent sub odometry + hand-eye accumulation
                self._sub_trackers[i], sub_out = tracker_step(
                    self._sub_trackers[i], se_, ss_, timestamp, self._sub_config,
                )
                pose_s = sub_out.pose.cpu().numpy()
                if self._anchors[i] is None:
                    self._anchors[i] = (pose_p, pose_s)
                    continue
                ap, asub = self._anchors[i]
                inc_p = np.float32(se3np.pose_between(ap, pose_p))
                inc_s = np.float32(se3np.pose_between(asub, pose_s))
                ang = float(np.linalg.norm(se3np.so3_log(se3np.pose_quat(inc_p))))
                if ang > cfg.handeye.min_rot_angle:
                    self._handeye[i] = handeye_add_pair(
                        self._handeye[i], self._pose_tensor(inc_p), self._pose_tensor(inc_s),
                        cfg.handeye,
                    )
                    self._anchors[i] = (pose_p, pose_s)
                    res = handeye_solve(self._handeye[i], cfg.handeye)
                    if bool(res.ok):
                        self.extrinsics[i] = res.extrinsic.cpu().numpy()
            elif self.calib_status == 1 and self._refine_ok[i] < cfg.calib_refine_frames:
                # phase 1: refine X against the primary local map. Single-
                # frame refinements scatter by centimeters–decimeters
                # (scan-dependent minima), so the extrinsic is the running
                # average of accepted refinements, not the last one.
                init = se3np.pose_compose(pose_p, self.extrinsics[i])
                reg = register_edge_surf(
                    se_, ss_, self.tracker_state.edge_flat, self.tracker_state.surf_flat,
                    self._pose_tensor(init), cfg.calib_refine_registration,
                )
                packed = torch.cat([
                    reg.pose.to(torch.float32),
                    reg.converged.to(torch.float32).reshape(1),
                    reg.n_constrained.to(torch.float32).reshape(1),
                ]).cpu().numpy()
                if bool(packed[7]) and int(packed[8]) == 6:
                    x_new = np.float32(se3np.pose_between(pose_p, packed[:7]))
                    self._refine_samples[i].append(x_new)
                    self.extrinsics[i] = _average_poses(self._refine_samples[i])
                    self._refine_ok[i] += 1
        if self.calib_status == 0 and all(e is not None for e in self.extrinsics):
            self.calib_status = 1
        if self.calib_status == 1 and all(
            k >= cfg.calib_refine_frames for k in self._refine_ok
        ):
            self.calib_status = 2

    def process_gnss(self, lla, pos_std: float = 0.1):
        """Fuse a GNSS fix into the IMU filter (requires ``use_imu``) and
        remember it so the next keyframe carries it as an absolute graph
        prior. The first fix anchors the local ENU frame (host float64); the
        ENU frame coincides with the odometry frame only up to the initial
        pose — production use pairs this with a yaw alignment."""
        if self._lio is None:
            raise ValueError("process_gnss requires use_imu=True")
        if self._enu is None:
            self._enu = make_enu_frame(np.asarray(lla, np.float64))
        pos = lla_to_enu(self._enu, lla)
        self._lio.eskf = eskf_update_position(
            self._lio.eskf, torch.as_tensor(pos, device=self.device), pos_std)
        self._pending_gnss = np.asarray(pos, np.float32)

    def process(
        self, scan, timestamp: float,
        gyro: Optional[np.ndarray] = None,
        acc: Optional[np.ndarray] = None,
        imu_dts: Optional[np.ndarray] = None,
        wheel_speeds: Optional[np.ndarray] = None,
    ) -> FrameResult:
        """One frame: featurize → track → (calibrate) → keyframe gate →
        backend.

        ``scan``: a PointBatch (on any device; the frame copies it to the
        system's), or a list of PointBatches, one a LiDAR, index 0 = primary.
        With ``use_imu``, pass the IMU window since the previous frame
        (gyro/acc (M,3), dts (M,), host arrays) for ESKF prediction + sweep
        deskew; ``wheel_speeds`` ((M,) or scalar) adds the encoder leg.
        Without ``use_imu`` the IMU arguments are ignored, as in the
        reference.

        The frame records its spans on ``timer`` (the backend's): ``frame``
        around the whole call, and inside it ``frame.featurize``,
        ``frame.track``, ``frame.read_back`` and ``frame.handoff``; under
        ``use_imu`` the LIO step's spans (``lio.*``) lie inside
        ``frame.track``."""
        with self.timer("frame"):
            read, edge, surf, scan_grid = self._front_end(
                scan, timestamp, gyro, acc, imu_dts, wheel_speeds)
            with self.timer("frame.handoff"):
                return self._finish_frame(timestamp, read, edge, surf, scan_grid)

    def _front_end(self, scan, timestamp, gyro, acc, imu_dts, wheel_speeds):
        """Featurize → track → the one read-back (→ calibrate): the
        (odom_pose, converged, num_matches) read back, and the frame's edge
        and surf clouds and range image."""
        scans = scan if isinstance(scan, (list, tuple)) else [scan]
        if len(scans) != self.config.n_lidars:
            raise ValueError(f"expected {self.config.n_lidars} scans, got {len(scans)}")
        with self.timer("frame.featurize"):
            feats = [self.featurize(s) for s in scans]
            scan_grid = feats[0][2]  # primary scan's range image (for carving)
            if self.calib_status == 2 and len(feats) > 1:
                # fused multi-lidar frame: sub features → primary sensor frame
                edges, surfs = [feats[0][0]], [feats[0][1]]
                for i, (se_, ss_, _) in enumerate(feats[1:]):
                    x = self._pose_tensor(self.extrinsics[i])
                    edges.append(se_.transform(x))
                    surfs.append(ss_.transform(x))
                f = self.config.feature
                n = self.config.n_lidars
                edge = pb_concat(edges, capacity=n * f.edge_capacity)
                surf = pb_concat(surfs, capacity=n * f.surf_capacity)
            else:
                # one LiDAR, or a calibration phase: the primary alone
                edge, surf = self._pad_to_fused(feats[0][0], feats[0][1])

        with self.timer("frame.track"):
            if self._lio is not None:
                # the LIO tracker registers without the range image: the
                # odometry map is not carved under IMU, as in the reference;
                # the backend still gets the grid
                _, out = self._lio.process_scan(
                    edge, surf, timestamp, gyro=gyro, acc=acc, imu_dts=imu_dts,
                    wheel_speeds=wheel_speeds,
                )
                self.tracker_state = self._lio.tracker_state
            else:
                self.tracker_state, out = tracker_step(
                    self.tracker_state, edge, surf, timestamp, self.tracker_config,
                    scan_grid=scan_grid if self.tracker_config.carve_map else None,
                )
        with self.timer("frame.read_back"):
            read = _read_back(out)
        if self.calib_status < 2:
            self._calibration_step(feats, read[0], timestamp)
        return read, edge, surf, scan_grid

    def _finish_frame(self, timestamp, read, edge, surf, scan_grid) -> FrameResult:
        """Keyframe gate → backend hand-off → FrameResult, from the frame's
        ONE copy of its per-frame scalars (``read``, taken before the gate);
        pose bookkeeping is host numpy (se3np)."""
        odom_pose, converged, num_matches = read

        backend_out: Optional[BackendOutput] = None
        is_kf = self.gate.need_update(odom_pose, timestamp)
        if is_kf:
            gnss = self._pending_gnss
            self._pending_gnss = None
            grid_kw = scan_grid if self.backend.config.dynamic_carve_knn > 0 else None
            if self._async is not None:
                # enqueue only: corrections arrive via the published odom2map;
                # GNSS priors and the scan grid ride the queue. The clouds and
                # the grid are fresh tensors of this frame's step, which
                # nothing writes in place afterwards.
                odom2map, mode, enqueued = self._async.submit(
                    timestamp, edge, surf, odom_pose, gnss_pos=gnss, scan_grid=grid_kw,
                )
                if not enqueued and gnss is not None:
                    # shed item ("drop" policy): the fix must not vanish —
                    # re-stash it so it rides the next stored keyframe
                    self._pending_gnss = gnss
                if mode is WorkMode.RELOCALIZATION:
                    # while the system does not know where it is, the
                    # frontend must not run ahead of the relocalizer:
                    # pre-reloc frames would be published in the odometry
                    # frame and every queued scan is a stale reloc attempt
                    # once one succeeds. Drain the queue so relocalization
                    # happens at frame cadence, then resume pipelining.
                    self._async.flush()
            else:
                backend_out = self.backend.add_keyframe(
                    timestamp, edge, surf, odom_pose, gnss_pos=gnss, scan_grid=grid_kw,
                )

        if self._async is not None:
            odom2map, mode = self._async.odom2map, self._async.mode
        else:
            odom2map, mode = self.backend.odom2map, self.backend.mode

        if backend_out is not None and backend_out.keyframe_id >= 0:
            map_pose = np.asarray(backend_out.map_pose)
        else:
            map_pose = np.asarray(se3np.pose_compose(odom2map, odom_pose), np.float32)
        result = FrameResult(
            timestamp=float(timestamp),
            odom_pose=odom_pose,
            map_pose=map_pose,
            mode=mode,
            is_keyframe=is_kf,
            keyframe_id=(backend_out.keyframe_id if backend_out else -1),
            loop_closed=bool(backend_out.loop_closed) if backend_out else False,
            converged=converged,
            num_matches=num_matches,
            calib_status=self.calib_status,
        )
        self.results.append(result)
        return result

    # -- trajectory / map export ----------------------------------------------

    def trajectory(self) -> np.ndarray:
        """Per-frame map-frame poses (N, 7)."""
        if not self.results:
            return np.zeros((0, 7), np.float32)
        return np.stack([r.map_pose for r in self.results])

    def keyframe_trajectory(self) -> np.ndarray:
        """Optimized keyframe poses from the backend database (K, 7)."""
        self.flush()
        return self.backend.db.map_poses[: self.backend.db.n_keyframes].copy()

    def global_map(self, voxel_size: float = 0.0) -> np.ndarray:
        """Assemble the global map from all keyframe clouds at their current
        optimized poses. Returns a compact (M, 3) numpy array."""
        self.flush()
        db = self.backend.db
        if db.n_keyframes == 0:
            return np.zeros((0, 3), np.float32)
        edge, surf = db.local_map_ids(np.arange(db.n_keyframes))
        pts = np.concatenate([edge.to_numpy(), surf.to_numpy()])
        if voxel_size > 0:
            keys = np.floor(pts / voxel_size).astype(np.int64)
            _, idx = np.unique(keys, axis=0, return_index=True)
            pts = pts[idx]
        return pts

    def occupancy_grid(self):
        """Synchronized 2D log-odds occupancy grid (None unless enabled via
        ``LifelongConfig.occupancy``)."""
        self.flush()
        return self.backend.occupancy_grid()

    def force_global_optimize(self):
        if self._async is not None:
            return self._async.force_global_optimize()
        return self.backend.force_global_optimize()

    def flush(self):
        """Drain the async backend (no-op for the sync backend)."""
        if self._async is not None:
            self._async.flush()

    # -- persistence ------------------------------------------------------------

    def save(self, path: str):
        self.flush()
        self.backend.save(path)

    @classmethod
    def load(cls, path: str, config: SystemConfig = SystemConfig(),
             storage_dir: Optional[str] = None, device="cuda") -> "MultiLidarSystem":
        """Boot from a saved lifelong database → backend starts in
        RELOCALIZATION, database and frame on ``device``. ``storage_dir``:
        session directory for disk-backed checkpoints."""
        backend = LifelongBackend.load(
            path, storage_dir=storage_dir, device=device, config=config.lifelong,
            loop_config=config.loop,
        )
        return cls(config=config, backend=backend, device=device)
