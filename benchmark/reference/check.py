"""The numbers that decide ``correct``, worked out by the plain reference.

The harness hands over what the run produced (every odometry pose returned
since the system's first frame, the tracker's ring state before the sampled
frames, the stored keyframes, the pose graph after the final flush, the
accepted loop verifications, a sample of the window's localizations)
together with the scans it fed, all on the host. From the scans the
reference derives every feature cloud and every map itself.

- ``frame_gap_m``: sampled frames; the reference rebuilds the tracker's
  registration map (:mod:`.localmap`: the scans the insertion rule put in
  the ring before the frame, their features at the poses returned for them,
  its own voxel downsample, and where probation is on the program's record
  of which points it admitted and the reference's carving), predicts the
  pose by constant velocity from the two poses returned before it, and
  registers the frame's features; the largest translation between that pose
  and the pose the system returned. A ring whose write index or fill count
  disagrees with the insertion rule counts 1000 m.
- ``map_gap_m``: the same frames' step of the tracker's state, checked by
  itself: the pose the state carries on equals the pose returned, and where
  the insertion rule admits the frame, the ring slot it wrote holds the
  reference's features at the returned pose (probation may leave points
  out, never move one); the largest gap (a missed or an extra insertion
  counts 1000 m).
- ``store_gap_m``: sampled stored keyframes; the largest distance between a
  stored point and the reference's feature in the same slot (a stored point
  whose slot the reference leaves empty counts 1000 m; points the backend
  carved away are not stored and count nothing), and between the stored
  odometry pose and the one the frame returned.
- ``graph_gap_m``: the whole pose graph after the flush, solved to
  convergence from the stored odometry poses, its odometry edges' means and
  weights worked out from those poses and the configuration (the loop edges'
  from the system); the largest translation between a solved keyframe pose
  and the system's.
- ``loop_gap_m`` (only where the graph holds loop edges): sampled loop
  edges; the verification redone: the new keyframe's features registered,
  rough stage then refine stage, from the verification's initial guess
  against the candidate's ±``adjacent_window`` local map (reference features
  at the map poses the verification found); the largest translation between
  that pose and the one the system found.
- ``loc_gap_m`` (only where the window localizes): sampled localizations;
  the reference picks the keyframes nearest the prediction among the map
  poses the backend held, builds the local map from their features at those
  poses, and registers the keyframe's features from the prediction; the
  largest translation between that pose and the one the system returned.

Where the configuration has ``use_imu`` (:mod:`.eskf`), a frame the program
ran with an IMU window is redone as the IMU-aided step: the system's filter
state from before the frame is propagated over the frame's window (with the
failure reset); the frame's features are deskewed by the motion from the pose
returned for the frame before to that prediction, at their sweep times;
they are registered from the prediction against the ring map (whose scans
are deskewed the same way, each by its own frame's propagated motion, and
which is not carved); the tracker's motion and prediction-trust gates decide
whether the solve is taken (else the pose coasts on the prediction), and the
filter is corrected by the pose only where it was. Then:

- ``frame_gap_m``: as above, against that pose.
- ``map_gap_m``: the ring slot against the deskewed features.
- ``filter_gap_m``, ``filter_bias_gap_sd``, ``filter_cov_gap`` (only where
  the payload carries filter states): the reference's corrected filter
  against the system's after each sampled frame, the whole state.
  ``filter_gap_m`` is the largest of the position gap in metres; the
  velocity gap times the frame interval (the position error it carries into
  the next frame's prediction); and the attitude gap (rad) times the
  sensor's ``max_range`` (how far it moves the farthest point the frame
  places in the map). ``filter_bias_gap_sd`` is each bias's gap in units of
  the reference filter's own standard deviation of that bias after the
  correction, the larger of the two: a bias reaches the pose only through
  later frames' propagation, and in units of the filter's own deviation the
  two biases read on one scale, where a gap in metres over one interval
  would weigh them by levers of its own choosing. ``filter_cov_gap``
  is the largest gap of a 3 × 3 block of the 15 × 15 covariance (position,
  velocity, attitude, the two biases), each block's Frobenius norm over the
  geometric mean of the norms of the two diagonal blocks it couples. Each
  sampled frame is redone from the system's own filter state before it, so
  the same three numbers also hold what links those steps: the state the
  system starts from against the filter's initial state (the seeded
  velocity, the rest at rest, the initial covariance), and each held frame's
  state before it against the state the frame before it left (no GNSS fix
  comes between frames in any cell).

Stored keyframes, loop verifications and localizations read the raw
(undeskewed) features the program hands its backend, as before.

``numbers(payload, control=False)`` gives them with the system's outputs
judged; ``control=True`` puts the reference itself in the system's place,
with every cloud and pose, and every IMU window and filter state, stored in
bfloat16 and the arithmetic in float32 (the step below the configuration's
float32), and judges that instead.
"""
from __future__ import annotations

import torch

from . import eskf, features, localmap, posegraph, registration, se3

MISSING_M = 1000.0


def _as(t, dtype, device):
    return torch.as_tensor(t).to(device=device, dtype=dtype)


class _Side:
    """One way of computing: the reference (float64 arithmetic on the
    float32 inputs) or the control (bfloat16 storage, float32 arithmetic).
    Features, range images and IMU-aided predictions are worked out once a
    frame."""

    def __init__(self, control: bool, device, cfg, payload):
        self.control = control
        self.device = device
        self.dtype = torch.float32 if control else torch.float64
        self.cfg, self.scan_of = cfg, payload["scan_of"]
        self.payload = payload
        self._feats, self._grids, self._ring, self._pred = {}, {}, {}, {}

    def store(self, t):
        t = _as(t, torch.float32, self.device)
        return t.to(torch.bfloat16).to(torch.float32) if self.control else t

    def calc(self, t):
        return self.store(t).to(self.dtype)

    def mask(self, m):
        return _as(m, torch.bool, self.device)

    def feats(self, scan):
        xyz, mask = scan
        cfg = self.cfg
        (ex, em), (sx, sm) = features.loam_features(
            self.store(xyz), self.mask(mask), cfg["feature"], cfg["min_range"], cfg["max_range"])
        return (self.calc(ex), em), (self.calc(sx), sm)

    def frame_feats(self, frame):
        if frame not in self._feats:
            self._feats[frame] = self.feats(self.scan_of(frame))
        return self._feats[frame]

    def filter(self, frame, which):
        """The system's filter state ``which`` ("before" or "after") the
        frame, as this side stores it."""
        return {k: self.calc(v) for k, v in self.payload["filters"][frame][which].items()}

    def predict(self, frame):
        """(filter state carried to the frame, IMU prediction or None,
        deskew motion or None): the IMU-aided step's start, from the
        system's filter state before the frame. No prediction where the
        program made none: its first frame, or a frame without a window."""
        if frame not in self._pred:
            odometry = self.payload["odometry"]
            st = self.filter(frame, "before")
            window = self.payload["imu_of"](frame)
            pred = motion = None
            if frame - 1 in odometry and window is not None and len(window[0]) > 0:
                gyro, acc, dts = (self.calc(w) for w in window)
                st, _ = eskf.reset_if_failed(eskf.propagate(st, gyro, acc, dts,
                                                            self.cfg["lio"]["eskf"]),
                                             self.cfg["lio"])
                pred = eskf.pose_of(st)
                motion = se3.between(self.calc(odometry[frame - 1]), pred)
            self._pred[frame] = (st, pred, motion)
        return self._pred[frame]

    def ring_feats(self, frame):
        """The frame's features as the tracker registers and stores them:
        deskewed by the frame's own predicted motion where the program
        deskewed them, else :meth:`frame_feats`."""
        if not self.cfg.get("lio"):
            return self.frame_feats(frame)
        motion = self.predict(frame)[2]
        if motion is None:
            return self.frame_feats(frame)
        if frame not in self._ring:
            xyz, mask = self.scan_of(frame)
            cfg = self.cfg
            times = self.payload["sweep_of"](frame)
            pairs = features.loam_features(self.store(xyz), self.mask(mask), cfg["feature"],
                                           cfg["min_range"], cfg["max_range"],
                                           times=self.store(times))
            self._ring[frame] = tuple(
                (eskf.deskew(self.calc(x), m, self.calc(t), motion), m) for x, m, t in pairs)
        return self._ring[frame]

    def grid(self, frame):
        if frame not in self._grids:
            xyz, mask = self.scan_of(frame)
            cfg = self.cfg
            g_xyz, g_rng, g_mask = features.range_image(
                self.store(xyz), self.mask(mask), cfg["feature"], cfg["min_range"],
                cfg["max_range"])
            self._grids[frame] = (self.calc(g_xyz), self.calc(g_rng), g_mask)
        return self._grids[frame]


def _insert_rule(cfg):
    ins = cfg["map_insert"]
    return {"trans": ins["trans"], "rot": ins["rot"], "dt": ins["dt"]}


def _ring_map(side, cfg, f, inserted, odometry):
    """The tracker's registration map before frame ``f``, or None where the
    program's ring disagrees with the insertion rule."""
    S = cfg["window"]
    before = [g for g in inserted if g < f["frame"]]
    ring = f["ring"]
    if ring["write_idx"] != len(before) % S or ring["count"] != min(len(before), S):
        return None
    held = before[-S:]
    parts = ([], [])
    for i, g in enumerate(held):
        slot = (len(before) - len(held) + i) % S
        pose = side.calc(odometry[g])
        for part, (x, m), prog in zip(parts, side.ring_feats(g),
                                      (ring["edge_mask"], ring["surf_mask"])):
            if cfg["probation"]:  # which points probation admitted: the program's record
                m = m & side.mask(prog[slot])[: m.shape[0]]
            part.append((se3.apply(pose, x), m))
    out = []
    for part, cap in zip(parts, cfg["map_capacity"]):
        if not part:
            out.append((torch.zeros(1, 3, dtype=side.dtype, device=side.device),
                        torch.zeros(1, dtype=torch.bool, device=side.device)))
            continue
        xyz, m = localmap.voxel_downsample(torch.cat([p[0] for p in part]),
                                           torch.cat([p[1] for p in part]), cfg["map_voxel"], cap)
        if cfg["carve"]:  # the system carves the rebuilt map with the scan that rebuilt it
            m = m & localmap.carve_keep(side.grid(held[-1]), xyz, m, side.calc(odometry[held[-1]]))
        out.append((xyz, m))
    return out


def _identity(side):
    eye = torch.zeros(7, dtype=side.dtype, device=side.device)
    eye[0] = 1.0
    return eye


def _prediction(side, odometry, frame):
    """Constant velocity from the two poses returned before ``frame`` (the
    tracker's first frame starts from the identity and its second from the
    first frame's pose)."""
    if frame - 1 not in odometry:
        return _identity(side)
    last = side.calc(odometry[frame - 1])
    if frame - 2 not in odometry:
        return last
    return se3.compose(last, se3.between(side.calc(odometry[frame - 2]), last))


def _frame_gap(side, cfg, frames, inserted, odometry):
    poses = []
    for f in frames:
        maps = _ring_map(side, cfg, f, inserted, odometry)
        if maps is None:
            poses.append(None)
            continue
        edge, surf = side.frame_feats(f["frame"])
        poses.append(registration.register(edge, surf, maps[0], maps[1],
                                           _prediction(side, odometry, f["frame"]),
                                           cfg["registration"]))
    return poses


def _gated(side, gates, gate, prev, new, pred):
    """(pose, solve taken) of the tracker's gates: the motion gate (a bound
    on the step from the last pose, relative to the smoothed speed once it
    has one) and the prediction-trust gate (a bound on the distance from the
    prediction); a refused solve coasts on the prediction, and a prediction
    the motion gate refuses holds the last pose."""
    speed = gate["speed_ema"]
    opened = speed <= 0.0 or gate["reject_streak"] >= gates["gate_reopen_after"]
    top = gates["max_motion_trans"]
    bound = top if opened else min(top, max(gates["motion_gate_k"] * speed, gates["motion_floor"]))

    def sane(p):
        d = se3.between(prev, p)
        return (float(torch.linalg.vector_norm(d[4:])) <= bound
                and float(torch.linalg.vector_norm(se3.so3_log(d[:4]))) <= gates["max_motion_rot"]
                and bool(torch.isfinite(p).all()))

    ok = sane(new)
    if gates["pred_trust_k"] > 0.0:
        trust = top if opened else max(gates["pred_trust_k"] * speed, gates["pred_trust_floor"])
        ok = ok and float(torch.linalg.vector_norm(se3.between(pred, new)[4:])) <= trust
    pose = new if ok else pred
    return (pose if sane(pose) else prev), ok


def _lio_frames(side, cfg, frames, inserted, odometry):
    """(poses, corrected filter states) of the sampled frames redone as the
    IMU-aided step (None where the ring disagrees with the insertion rule)."""
    poses, states = [], []
    lio = cfg["lio"]
    for f in frames:
        frame = f["frame"]
        try:  # a ring off the insertion rule, or a filter state not held
            maps = _ring_map(side, cfg, f, inserted, odometry)
            st, pred, _ = side.predict(frame)
        except KeyError:
            maps = None
        if maps is None:
            poses.append(None)
            states.append(None)
            continue
        first = frame - 1 not in odometry
        if pred is None:  # the tracker's own constant-velocity prediction
            pred = _prediction(side, odometry, frame)
        edge, surf = side.ring_feats(frame)
        new = registration.register(edge, surf, maps[0], maps[1], pred, cfg["registration"])
        prev = _identity(side) if first else side.calc(odometry[frame - 1])
        if first:  # no map yet: the tracker stays at the identity
            new = prev
        pose, ok = _gated(side, lio["gates"], f["gate"], prev, new, pred)
        poses.append(pose)
        states.append(eskf.update_pose(st, pose, lio["reg_pos_std"], lio["reg_rot_std"])
                      if ok else st)
    return poses, states


def _blocks(cov):
    """(5, 5) Frobenius norms of the 3 × 3 blocks of a 15 × 15 covariance."""
    return torch.linalg.matrix_norm(cov.reshape(5, 3, 5, 3).transpose(1, 2))


def _filter_gap(judged, ref, interval, lever):
    """(state gap m, bias gap in standard deviations, covariance gap) of a
    judged filter state against a reference one, as the module docstring
    sets them out (a state missing on either side: 1000 each)."""
    if judged is None or ref is None:
        return MISSING_M, MISSING_M, MISSING_M
    n = torch.linalg.vector_norm
    j = {k: v.double() for k, v in judged.items()}
    r = {k: v.double() for k, v in ref.items()}
    turn = n(se3.so3_log(se3.qmul(se3.qconj(r["q"]), j["q"])))
    state = max(n(j["p"] - r["p"]), n(j["v"] - r["v"]) * interval, turn * lever)
    sd = torch.sqrt(torch.diagonal(r["cov"]).reshape(5, 3).mean(dim=1))
    bias = max(n(j["ba"] - r["ba"]) / sd[3], n(j["bg"] - r["bg"]) / sd[4])
    norms = _blocks(r["cov"])
    scale = torch.sqrt(torch.diagonal(norms)[:, None] * torch.diagonal(norms)[None, :])
    cov = torch.max(_blocks(j["cov"] - r["cov"]) / scale)
    return float(state), float(bias), float(cov)


def _filter_links(payload, cfg, dev):
    """(judged, reference) pairs of the links between the redone steps: the
    first held state against the filter's initial state, where the held
    frames start at the system's first frame, and each held frame's state
    before it against the state the frame before it left."""
    held = payload["filters"]
    pairs = []
    first = min(held)
    if first == min(payload["odometry"]):
        like = torch.zeros(3, dtype=torch.float64, device=dev)
        v0 = payload["filter_start_v"]  # the velocity seeded at build (none: at rest)
        start = {"p": like, "v": like if v0 is None else _as(v0, torch.float64, dev),
                 "q": torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64, device=dev),
                 "ba": like, "bg": like, "cov": eskf.init_cov(cfg["lio"]["eskf"], like)}
        pairs.append((held[first]["before"], start))
    for k in sorted(held):
        if k - 1 in held:
            pairs.append((held[k]["before"], held[k - 1]["after"]))
    return [({f: _as(v, torch.float64, dev) for f, v in a.items()},
             {f: _as(v, torch.float64, dev) for f, v in b.items()}) for a, b in pairs]


def _slot_gap(slot, feats, pose, dev):
    """Largest distance of a slot's valid points from the features moved by
    ``pose`` in the same places (a place the features leave empty: 1000 m)."""
    (fx, fm), (px, pm) = feats, slot
    moved = se3.apply(pose.double(), fx.double())
    d = torch.linalg.vector_norm(_as(px, torch.float64, dev) - moved, dim=-1)
    d = torch.where(fm, d, MISSING_M)
    pm = _as(pm, torch.bool, dev)
    return float(torch.max(torch.where(pm, d, 0.0))) if bool(pm.any()) else 0.0


def _map_gap(ref, frames, inserted, ctl=None):
    """``ctl``: the control side and its poses of the same frames beside the
    reference's, judged in place of the system's state step."""
    out = []
    dev = ref.device
    for i, f in enumerate(frames):
        a = f.get("after")
        if a is None:
            continue
        edge, surf = ref.ring_feats(f["frame"])
        if ctl is not None:
            side, cposes, rposes = ctl
            cpose, rpose = cposes[i], rposes[i]
            if cpose is None or rpose is None:
                out.append(MISSING_M)
                continue
            gap = float(se3.gap_m(cpose.double(), rpose))
            for (cx, cm), (rx, rm) in zip(side.ring_feats(f["frame"]), (edge, surf)):
                moved = (se3.apply(cpose.double(), cx.double()), cm & rm)
                gap = max(gap, _slot_gap(moved, (rx, rm), rpose, dev))
            out.append(gap)
            continue
        returned = _as(f["pose"], torch.float64, dev)
        gap = float(se3.gap_m(_as(a["pose"], torch.float64, dev), returned))
        if (f["frame"] in inserted) != a["written"]:
            gap = MISSING_M
        elif a["written"]:
            gap = max(gap, _slot_gap(a["edge_slot"], edge, returned, dev),
                      _slot_gap(a["surf_slot"], surf, returned, dev))
        out.append(gap)
    return out


def _store_gap(side, stored):
    out = []
    for k in stored:
        (ex, em), (sx, sm) = side.frame_feats(k["frame"])
        worst = float(se3.gap_m(side.calc(k["pose_stored"]).double(),
                                _as(k["pose_returned"], torch.float64, side.device)))
        for (rx, rm), (px, pm) in (((ex, em), k["edge"]), ((sx, sm), k["surf"])):
            px = _as(px, torch.float64, side.device)
            pm = side.mask(pm)
            d = torch.linalg.vector_norm(px - rx.double(), dim=-1)
            d = torch.where(rm, d, MISSING_M)
            if bool(pm.any()):
                worst = max(worst, float(torch.max(torch.where(pm, d, 0.0))))
        out.append(worst)
    return out


def _graph(side, g, cfg):
    """The graph solved from the stored odometry poses (re-anchored on the
    fixed first vertex's map pose); an odometry edge's mean is the odometry
    between its ends and its weights the configuration's."""
    dev = side.device
    odom = side.calc(g["odom"])
    eij = _as(g["eij"], torch.long, dev)
    loop = side.mask(g["loop"])
    z = torch.where(loop[:, None], side.calc(g["z"]),
                    se3.between(odom[eij[:, 0]], odom[eij[:, 1]]))
    odom_w = 1.0 / torch.sqrt(torch.tensor(cfg["odom_noise"], dtype=side.dtype, device=dev))
    sqrtw = torch.where(loop[:, None], _as(g["sqrtw"], side.dtype, dev), odom_w[None, :])
    anchor = se3.compose(side.calc(g["poses"][0]), se3.inverse(odom[0]))
    start = se3.compose(anchor.expand(odom.shape[0], 7), odom)
    return posegraph.solve(start, eij, z, sqrtw, loop, delta=cfg["graph_delta"])


def _loop_gap(side, cfg, loops):
    out = []
    for lp in loops:
        edge, surf = side.feats(lp["scan"])
        me, ms = [], []
        for scan, pose in lp["neighbours"]:
            (ex, em), (sx, sm) = side.feats(scan)
            p = side.calc(pose)
            me.append((se3.apply(p, ex), em))
            ms.append((se3.apply(p, sx), sm))
        map_edge = (torch.cat([c[0] for c in me]), torch.cat([c[1] for c in me]))
        map_surf = (torch.cat([c[0] for c in ms]), torch.cat([c[1] for c in ms]))
        rough = registration.register(edge, surf, map_edge, map_surf, side.calc(lp["init"]),
                                      cfg["loop_rough"])
        pose = registration.register(edge, surf, map_edge, map_surf, rough, cfg["loop_refine"])
        out.append(pose)
    return out


def _loc_gap(side, cfg, locs):
    """The localizations redone: the keyframes nearest the prediction (the
    lowest id first among equals), their features at their map poses (less
    what the store carved), registered from the prediction."""
    out = []
    for lp in locs:
        edge, surf = side.frame_feats(lp["frame"])
        poses = side.calc(lp["map_poses"])
        pred = side.calc(lp["pred"])
        d2 = torch.sum((poses[:, 4:] - pred[None, 4:]) ** 2, dim=-1)
        ids = torch.sort(d2, stable=True).indices[: cfg["localization_knn"]].tolist()
        me, ms = [], []
        for i in ids:
            (ex, em), (sx, sm) = side.frame_feats(lp["keyframe_frames"][i])
            kem, ksm = lp["keyframe_masks"][i]
            me.append((se3.apply(poses[i], ex), em & side.mask(kem)[: em.shape[0]]))
            ms.append((se3.apply(poses[i], sx), sm & side.mask(ksm)[: sm.shape[0]]))
        map_edge = (torch.cat([c[0] for c in me]), torch.cat([c[1] for c in me]))
        map_surf = (torch.cat([c[0] for c in ms]), torch.cat([c[1] for c in ms]))
        out.append(registration.register(edge, surf, map_edge, map_surf, pred,
                                         cfg["localization"]))
    return out


def _worst(judged, ref_poses):
    """Largest translation between judged and reference poses (a pose
    missing on either side: 1000 m)."""
    gaps = [MISSING_M if j is None or r is None else float(se3.gap_m(
        j.double() if torch.is_tensor(j) else torch.as_tensor(j, dtype=torch.float64, device=r.device),
        r.double())) for j, r in zip(judged, ref_poses)]
    return max(gaps)


def numbers(payload: dict, control: bool = False) -> dict:
    """{name: value} of the payload's checks; ``control`` judges the
    reference in bfloat16 storage in place of the system's outputs."""
    cfg = payload["config"]
    dev = torch.device(payload.get("device", "cpu"))
    ref = _Side(False, dev, cfg, payload)
    ctl = _Side(True, dev, cfg, payload) if control else None
    odometry = payload["odometry"]
    inserted = localmap.insertions(odometry, lambda k: payload["stamp"] * k, _insert_rule(cfg))
    out = {}
    with torch.no_grad():
        frames = payload["frames"]
        if not frames:  # a window too short to reach the sampled frames: nothing to judge
            return out
        if cfg.get("lio"):
            rposes, rstates = _lio_frames(ref, cfg, frames, inserted, odometry)
            if control:
                cposes, cstates = _lio_frames(ctl, cfg, frames, inserted, odometry)
            else:
                cstates = [{k: _as(v, torch.float64, dev) for k, v in
                            payload["filters"][f["frame"]]["after"].items()}
                           if f["frame"] in payload["filters"] else None for f in frames]
            if payload["filters"]:
                pairs = list(zip(cstates, rstates))
                if not control:  # the control has no chain of its own to link
                    pairs += _filter_links(payload, cfg, dev)
                gaps = [_filter_gap(c, r, payload["stamp"], cfg["max_range"]) for c, r in pairs]
                for i, name in enumerate(("filter_gap_m", "filter_bias_gap_sd", "filter_cov_gap")):
                    out[name] = max(g[i] for g in gaps)
        else:
            rposes = _frame_gap(ref, cfg, frames, inserted, odometry)
            if control:
                cposes = _frame_gap(ctl, cfg, frames, inserted, odometry)
        if control:
            out["frame_gap_m"] = _worst(cposes, rposes)
        else:
            out["frame_gap_m"] = _worst([f["pose"] for f in frames], rposes)
        maps = _map_gap(ref, frames, set(inserted), (ctl, cposes, rposes) if control else None)
        if maps:
            out["map_gap_m"] = max(maps)

        if payload["stored"]:
            if control:
                stored = []
                for k in payload["stored"]:
                    (ex, em), (sx, sm) = ctl.frame_feats(k["frame"])
                    stored.append(dict(k, edge=(ex.float().cpu(), em.cpu()),
                                       surf=(sx.float().cpu(), sm.cpu()),
                                       pose_stored=k["pose_returned"]))
            else:
                stored = payload["stored"]
            out["store_gap_m"] = max(_store_gap(ref, stored))

        g = payload["graph"]
        if g is not None:
            solved = _graph(ref, g, cfg)
            judged = _graph(ctl, g, cfg).double() if control else _as(g["poses"], torch.float64, dev)
            out["graph_gap_m"] = float(torch.max(se3.gap_m(judged, solved)))

        if payload["loops"]:
            rl = _loop_gap(ref, cfg, payload["loops"])
            judged = _loop_gap(ctl, cfg, payload["loops"]) if control else [
                lp["pose"] for lp in payload["loops"]]
            out["loop_gap_m"] = _worst(judged, rl)

        if payload["locs"]:
            rl = _loc_gap(ref, cfg, payload["locs"])
            judged = _loc_gap(ctl, cfg, payload["locs"]) if control else [
                lp["pose"] for lp in payload["locs"]]
            out["loc_gap_m"] = _worst(judged, rl)
    return out
