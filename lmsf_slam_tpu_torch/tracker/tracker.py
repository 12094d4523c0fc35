"""Scan-to-local-map LiDAR odometry tracker.

Counterpart of ``lmsf_slam_tpu/tracker/tracker.py``: constant-velocity
prediction, edge+surf Gauss-Newton registration against a voxel-downsampled
sliding-window local map, motion / prediction-trust health gates, optional
constant-velocity deskew passes, the scene-flow gate and insert probation
(both through ``nn1``, i.e. the k-NN kernel with k=1), a branchless
ring-buffer map update, and free-space carving of the rebuilt registration
maps with the scan's range image (``carve_map``).

``tracker_step`` is a plain function of tensors with no host read: every
decision the reference takes with ``jnp.where`` / ``lax.cond`` is a
``torch.where`` here.
"""
from __future__ import annotations

from typing import NamedTuple

import math

import torch

from ..common import se3
from ..common.pointcloud import ATTR_TIME, PointBatch
from ..ops.dynamic import carve_dynamic
from ..ops.neighbors import nn1
from ..ops.preprocess import deskew as _deskew
from ..ops.registration import RegistrationParams, RegistrationResult, register_edge_surf
from ..ops.voxel import voxel_downsample
from .localmap import LocalMapState, localmap_add_if, localmap_empty, localmap_flatten


class TrackerConfig(NamedTuple):
    window: int = 20  # local-map scans
    edge_capacity: int = 2048  # per-scan edge points in the map
    surf_capacity: int = 8192  # per-scan surf points in the map
    map_update_trans: float = 0.3  # m
    map_update_rot: float = 0.1  # rad
    map_update_dt: float = 10.0  # s
    # registration runs against a voxel-downsampled snapshot of the window
    map_voxel_size: float = 0.25  # m
    edge_map_capacity: int = 8192  # downsampled map capacities (static)
    surf_map_capacity: int = 16384
    registration: RegistrationParams = RegistrationParams()
    # odometry failure gate: implausible increments are rejected
    max_motion_trans: float = 10.0  # m/frame
    max_motion_rot: float = 1.5  # rad/frame
    # speed-relative bound min(max_motion_trans, max(motion_floor, k·EMA))
    motion_floor: float = 2.0  # m/frame always allowed
    motion_gate_k: float = 3.0
    speed_ema_alpha: float = 0.3
    gate_reopen_after: int = 3
    # prediction-trust gate (0 disables)
    pred_trust_k: float = 0.0
    pred_trust_floor: float = 0.5
    # map-insertion health gate: minimum correspondences of the solve
    map_insert_min_matches: int = 32
    # IMU-free constant-velocity sweep deskew (needs the ATTR_TIME column)
    deskew: bool = False
    # dynamic-object probation gate at map insert
    probation: bool = False
    support_radius: float = 0.6  # m — map-supported admission
    consist_radius: float = 0.3  # m — probation re-sighting admission
    # free-space carving of the registration map at every rebuild, with the
    # range image of the scan that triggered it (``tracker_step(scan_grid=)``)
    carve_map: bool = False
    # ego-motion-compensated scene-flow gate before registration (0 disables)
    flow_gate: float = 0.0  # m at zero range
    flow_rel: float = 0.02  # + this fraction of point range
    flow_floor: float = 0.3
    probation_sightings: int = 3
    probation_starvation_floor: float = 0.3
    # iterative re-deskew: registrations per frame and the sweep update gain
    deskew_passes: int = 1
    deskew_gain: float = 1.0


class TrackerState(NamedTuple):
    pose: torch.Tensor  # (7,) current pose in odom frame
    motion: torch.Tensor  # (7,) last inter-frame increment (const-velocity)
    speed_ema: torch.Tensor  # f32 — smoothed accepted per-frame speed (m)
    reject_streak: torch.Tensor  # int32 — consecutive motion-gate rejections
    edge_map: LocalMapState
    surf_map: LocalMapState
    edge_flat: PointBatch  # cached voxel-downsampled union map (odom frame)
    surf_flat: PointBatch
    last_update_pose: torch.Tensor  # (7,) pose at last map insertion
    last_update_time: torch.Tensor  # f32
    frame_count: torch.Tensor  # int32
    # probation cloud (world frame): first-seen anchors, validity and
    # sighting counts; (0, 3) unless config.probation
    prob_xyz: torch.Tensor
    prob_mask: torch.Tensor
    prob_count: torch.Tensor
    # previous raw scan in the world frame (scene-flow gate reference);
    # (0, 3) unless config.flow_gate > 0
    flow_xyz: torch.Tensor
    flow_mask: torch.Tensor


class TrackerOutput(NamedTuple):
    pose: torch.Tensor  # (7,)
    motion: torch.Tensor  # (7,)
    registration: RegistrationResult
    map_updated: torch.Tensor  # bool
    solve_ok: torch.Tensor  # bool — False: pose fell back to prediction


def _fit_cap(x, m, cap):
    """Clip/pad a cloud to exactly ``cap`` rows (static-shape state slots)."""
    n = x.shape[0]
    if n >= cap:
        return x[:cap], m[:cap]
    return (
        torch.nn.functional.pad(x, (0, 0, 0, cap - n)),
        torch.nn.functional.pad(m, (0, cap - n)),
    )


def tracker_init(config: TrackerConfig, device="cuda") -> TrackerState:
    n_prob = (config.edge_capacity + config.surf_capacity) if config.probation else 0
    n_flow = (config.edge_capacity + config.surf_capacity) if config.flow_gate > 0 else 0

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    return TrackerState(
        pose=se3.pose_identity(device=device),
        motion=se3.pose_identity(device=device),
        speed_ema=scalar(0.0, torch.float32),
        reject_streak=scalar(0, torch.int32),
        edge_map=localmap_empty(config.window, config.edge_capacity, device),
        surf_map=localmap_empty(config.window, config.surf_capacity, device),
        edge_flat=PointBatch.empty(config.edge_map_capacity, device=device),
        surf_flat=PointBatch.empty(config.surf_map_capacity, device=device),
        last_update_pose=se3.pose_identity(device=device),
        last_update_time=scalar(-1e18, torch.float32),
        frame_count=scalar(0, torch.int32),
        prob_xyz=torch.zeros((n_prob, 3), dtype=torch.float32, device=device),
        prob_mask=torch.zeros(n_prob, dtype=torch.bool, device=device),
        prob_count=torch.zeros(n_prob, dtype=torch.int32, device=device),
        flow_xyz=torch.zeros((n_flow, 3), dtype=torch.float32, device=device),
        flow_mask=torch.zeros(n_flow, dtype=torch.bool, device=device),
    )


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def tracker_step(
    state: TrackerState,
    edge: PointBatch,
    surf: PointBatch,
    timestamp: torch.Tensor,
    config: TrackerConfig = TrackerConfig(),
    prediction: torch.Tensor | None = None,
    scan_grid=None,  # organized range image (sensor frame) for carve_map
) -> tuple[TrackerState, TrackerOutput]:
    """One odometry step: predict → register vs local map → maybe update map.

    ``prediction``: optional externally predicted pose (odom frame);
    defaults to constant-velocity extrapolation.
    """
    dev = state.pose.device
    f32 = torch.float32
    timestamp = torch.as_tensor(timestamp, dtype=f32, device=dev)
    identity = se3.pose_identity(device=dev)
    first = state.frame_count == 0
    if prediction is None:
        prediction = se3.pose_compose(state.pose, state.motion)

    # speed-relative translation bound; cold gate (no accepted motion yet)
    # or a re-acquire after gate_reopen_after rejections → insanity ceiling
    gate_open = (state.speed_ema <= 0.0) | (
        state.reject_streak >= config.gate_reopen_after
    )
    max_trans = torch.tensor(config.max_motion_trans, dtype=f32, device=dev)
    trans_bound = torch.where(
        gate_open,
        max_trans,
        torch.minimum(
            max_trans,
            torch.clamp(config.motion_gate_k * state.speed_ema, min=config.motion_floor),
        ),
    )

    def _sane(p):
        d = se3.pose_between(state.pose, p)
        return (
            (_norm(se3.pose_trans(d)) <= trans_bound)
            & (_norm(se3.so3_log(se3.pose_quat(d))) <= config.max_motion_rot)
            & torch.all(torch.isfinite(p))
        )

    if config.deskew and edge.attr.shape[-1] > 0:
        # iterative re-deskew: deskew with the current sweep iterate,
        # register, measure the solved motion, repeat
        raw_edge, raw_surf = edge, surf
        sweep = torch.where(first, identity, state.motion)
        pred_i = prediction
        for _ in range(config.deskew_passes):
            edge = _deskew(raw_edge, raw_edge.attr[:, ATTR_TIME], sweep)
            surf = _deskew(raw_surf, raw_surf.attr[:, ATTR_TIME], sweep)
            reg_i = register_edge_surf(
                edge, surf, state.edge_flat, state.surf_flat, pred_i,
                config.registration,
            )
            ok_i = (
                _sane(reg_i.pose)
                & (reg_i.num_matches >= config.map_insert_min_matches)
                & ~first
            )
            measured = se3.pose_between(state.pose, reg_i.pose)
            # damped update of the sweep iterate (geodesic interpolation)
            a = torch.where(ok_i, torch.tensor(config.deskew_gain, dtype=f32, device=dev), 0.0)
            sweep = se3.pose_retract(
                sweep, a * se3.pose_log(se3.pose_between(sweep, measured))
            )
            pred_i = torch.where(ok_i, reg_i.pose, pred_i)
        edge = _deskew(raw_edge, raw_edge.attr[:, ATTR_TIME], sweep)
        surf = _deskew(raw_surf, raw_surf.attr[:, ATTR_TIME], sweep)
        prediction = pred_i

    raw_edge_in, raw_surf_in = edge, surf  # pre-flow-gate (flow reference)
    if config.flow_gate > 0:

        def _flow_static(pb):
            w = pb.transform(prediction)
            d, _ = nn1(w.xyz, w.mask, state.flow_xyz, state.flow_mask)
            rng = _norm(pb.xyz)  # sensor-frame range
            thr = config.flow_gate + config.flow_rel * rng
            return d < thr * thr

        stat_e = _flow_static(edge)
        stat_s = _flow_static(surf)
        n_val = torch.clamp(torch.sum(edge.mask) + torch.sum(surf.mask), min=1)
        frac = (torch.sum(stat_e & edge.mask) + torch.sum(stat_s & surf.mask)) / n_val
        stand_down = (frac < config.flow_floor) | first
        edge = PointBatch(edge.xyz, edge.mask & (stat_e | stand_down), edge.attr)
        surf = PointBatch(surf.xyz, surf.mask & (stat_s | stand_down), surf.attr)

    reg = register_edge_surf(
        edge, surf, state.edge_flat, state.surf_flat, prediction,
        config.registration,
    )
    # first frame: no map yet — stay at identity
    new_pose = torch.where(first, identity, reg.pose)

    # odometry failure gate: reject an implausible solve (fall back to the
    # prediction); if even the prediction is implausible, hold position
    solve_ok = _sane(new_pose)
    if config.pred_trust_k > 0.0:
        # prediction-trust gate: reject a solve far from the prediction
        # (relative to the smoothed speed) and coast on the prediction
        dev_pred = _norm(se3.pose_trans(se3.pose_between(prediction, new_pose)))
        pred_bound = torch.where(
            gate_open,
            max_trans,
            torch.clamp(config.pred_trust_k * state.speed_ema, min=config.pred_trust_floor),
        )
        solve_ok = solve_ok & (dev_pred <= pred_bound)
    new_pose = torch.where(solve_ok, new_pose, prediction)
    pred_ok = _sane(new_pose)
    new_pose = torch.where(pred_ok, new_pose, state.pose)
    motion = se3.pose_between(state.pose, new_pose)

    # map-update decision
    delta = se3.pose_between(state.last_update_pose, new_pose)
    dx = _norm(se3.pose_trans(delta))
    dr = _norm(se3.so3_log(se3.pose_quat(delta)))
    need = (
        first
        | (dx > config.map_update_trans)
        | (dr > config.map_update_rot)
        | (timestamp - state.last_update_time > config.map_update_dt)
    )
    # registration health gate: enough correspondences + a plausible solve
    healthy = solve_ok & (reg.num_matches >= config.map_insert_min_matches)
    need = need & (first | healthy)

    edge_w = edge.transform(new_pose)
    surf_w = surf.transform(new_pose)
    prob_xyz, prob_mask = state.prob_xyz, state.prob_mask
    prob_count = state.prob_count
    flow_xyz, flow_mask = state.flow_xyz, state.flow_mask
    if config.flow_gate > 0:
        # refresh the scene-flow reference every frame with the UNGATED
        # scan at the solved pose
        rw_e = raw_edge_in.transform(new_pose)
        rw_s = raw_surf_in.transform(new_pose)
        fe_xyz, fe_mk = _fit_cap(rw_e.xyz, rw_e.mask, config.edge_capacity)
        fs_xyz, fs_mk = _fit_cap(rw_s.xyz, rw_s.mask, config.surf_capacity)
        flow_xyz = torch.cat([fe_xyz, fs_xyz])
        flow_mask = torch.cat([fe_mk, fs_mk])
    if config.probation:
        ne_cap, ns_cap = config.edge_capacity, config.surf_capacity
        pe_xyz, pe_mk = _fit_cap(edge_w.xyz, edge_w.mask, ne_cap)
        ps_xyz, ps_mk = _fit_cap(surf_w.xyz, surf_w.mask, ns_cap)
        new_xyz = torch.cat([pe_xyz, ps_xyz])
        new_mk = torch.cat([pe_mk, ps_mk])
        map_xyz = torch.cat([state.edge_flat.xyz, state.surf_flat.xyz])
        map_mk = torch.cat([state.edge_flat.mask, state.surf_flat.mask])
        d_map, _ = nn1(new_xyz, new_mk, map_xyz, map_mk)
        d_prob, p_idx = nn1(new_xyz, new_mk, prob_xyz, prob_mask)
        matched = d_prob < config.consist_radius**2
        # matched points inherit their probation entry's ORIGINAL anchor and
        # increment its count (nn1 indices are always in range; unmatched
        # lanes read entry 0 and are discarded, as the reference's clamp)
        p_idx = torch.where(matched, p_idx, 0).long()
        count = torch.where(matched, state.prob_count[p_idx] + 1, 1).to(torch.int32)
        anchor = torch.where(matched[:, None], prob_xyz[p_idx], new_xyz)
        admit = (
            (d_map < config.support_radius**2)
            | (matched & (count >= config.probation_sightings))
            | first
        )
        n_valid = torch.clamp(torch.sum(new_mk), min=1)
        starved = torch.sum(admit & new_mk) / n_valid < config.probation_starvation_floor
        admit = admit | starved

        def _apply(pb, adm, cap):
            n = pb.mask.shape[0]
            a = adm[:n] if n <= cap else torch.nn.functional.pad(adm, (0, n - cap))
            return PointBatch(pb.xyz, pb.mask & a, pb.attr)

        edge_w = _apply(edge_w, admit[:ne_cap], ne_cap)
        surf_w = _apply(surf_w, admit[ne_cap:], ns_cap)
        # next probation set: seen this update, admitted by neither rule
        prob_xyz = torch.where(need, anchor, prob_xyz)
        prob_mask = torch.where(need, new_mk & ~admit, prob_mask)
        prob_count = torch.where(need, count, state.prob_count)
    new_edge_map = localmap_add_if(state.edge_map, edge_w, need)
    new_surf_map = localmap_add_if(state.surf_map, surf_w, need)

    # The reference rebuilds the downsampled registration maps under
    # lax.cond(need, ...). Here they are rebuilt every frame and selected
    # with torch.where: a host read of `need` would synchronise the card in
    # the middle of the step, and the rebuild (one sort + three index_adds
    # per map) costs less than that round trip.
    ef = voxel_downsample(
        localmap_flatten(new_edge_map), config.map_voxel_size,
        config.edge_map_capacity,
    )
    sf = voxel_downsample(
        localmap_flatten(new_surf_map), config.map_voxel_size,
        config.surf_map_capacity,
    )
    if config.carve_map and scan_grid is not None:
        # the scan's own elevation limits, left on the device
        gm = scan_grid.mask
        elev = torch.atan2(scan_grid.xyz[..., 2], _norm(scan_grid.xyz[..., :2]) + 1e-9)
        elo = torch.min(torch.where(gm, elev, math.inf))
        ehi = torch.max(torch.where(gm, elev, -math.inf))
        ef = PointBatch(
            ef.xyz,
            ef.mask & carve_dynamic(scan_grid, ef, new_pose, elev_min=elo, elev_max=ehi),
            ef.attr,
        )
        sf = PointBatch(
            sf.xyz,
            sf.mask & carve_dynamic(scan_grid, sf, new_pose, elev_min=elo, elev_max=ehi),
            sf.attr,
        )
    edge_flat = PointBatch(*(torch.where(need, a, b) for a, b in zip(
        (ef.xyz, ef.mask, ef.attr), (state.edge_flat.xyz, state.edge_flat.mask,
                                     state.edge_flat.attr))))
    surf_flat = PointBatch(*(torch.where(need, a, b) for a, b in zip(
        (sf.xyz, sf.mask, sf.attr), (state.surf_flat.xyz, state.surf_flat.mask,
                                     state.surf_flat.attr))))

    speed = _norm(se3.pose_trans(motion))
    a = torch.tensor(config.speed_ema_alpha, dtype=f32, device=dev)
    new_state = TrackerState(
        pose=new_pose,
        motion=torch.where(first, identity, motion),
        speed_ema=torch.where(first, state.speed_ema, (1.0 - a) * state.speed_ema + a * speed),
        reject_streak=torch.where(
            first | solve_ok, torch.zeros_like(state.reject_streak),
            state.reject_streak + 1,
        ),
        edge_map=new_edge_map,
        surf_map=new_surf_map,
        edge_flat=edge_flat,
        surf_flat=surf_flat,
        last_update_pose=torch.where(need, new_pose, state.last_update_pose),
        last_update_time=torch.where(need, timestamp, state.last_update_time),
        frame_count=state.frame_count + 1,
        prob_xyz=prob_xyz,
        prob_mask=prob_mask,
        prob_count=prob_count,
        flow_xyz=flow_xyz,
        flow_mask=flow_mask,
    )
    return new_state, TrackerOutput(
        pose=new_pose, motion=motion, registration=reg, map_updated=need,
        solve_ok=solve_ok,
    )
