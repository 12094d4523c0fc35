"""One run of one cell: load, set up, measure for ``--seconds``, check the
output against the plain reference, print one JSON line.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is found by its name in ``BENCHMARK.json``: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``metrics/<metric>.py`` (a ``read(ctx)`` that
returns a number, or None where the run has nothing to read) and
``limits/<workload>.json`` (the limits of the numbers that decide
``correct``). Adding a cell, a mix or a metric adds files and entries and
edits none.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names a run may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "lmsf_slam_tpu")
TRACE_FRAMES = 20  # frames inside the profiler in a traced run
TRACE_SKIP = 5  # window frames before the traced ones
LOC_SAMPLES = 3  # window localizations the reference redoes


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def quantile(values, q):
    """The q-quantile (0..1) of all values, by linear interpolation between
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latency_stats(lat_s):
    return {"frame_p50_ms": 1e3 * statistics.median(lat_s), "frame_p95_ms": 1e3 * quantile(lat_s, 0.95)}


def load_spec(workload: str, root: Path = ROOT):
    """(cell, configuration, mix, limits, end-to-end metrics, per-layer
    metrics) of ``workload``, from ``BENCHMARK.json`` and the files it names."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    base = root / bench["paths"][0]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{workload}.json").read_text())

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    layer = [m for m in bench["per_layer"] if applies(m)]
    return cell, config, mix, limits, e2e, layer, base


def load_reader(base: Path, name: str):
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", base / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the measured window ------------------------------------------------------


def closed_window(sut, system, traffic, pool, first, seconds, trace_hook=None):
    """Offer pool frames (each a scan and its IMU window) one after another,
    each once the previous pose is back, until ``seconds`` have passed; then
    flush inside the clock."""
    lat, backlog, returned = [], [], []
    k = 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        if k >= len(pool):
            raise RuntimeError(f"the window used up the pool of {len(pool)} frames")
        if trace_hook is not None:
            trace_hook(k)
        t0 = time.perf_counter()
        res = sut.process(system, pool[k], traffic.stamp(first + k))
        lat.append(time.perf_counter() - t0)
        backlog.append(sut.backlog(system))
        returned.append(res)
        k += 1
    if trace_hook is not None:
        trace_hook(k, last=True)
    system.flush()
    window = time.perf_counter() - t_start
    return {"latency_s": lat, "window_s": window, "backlog": backlog, "results": returned,
            "late_s": 0.0}


def open_window(sut, system, traffic, pool, rate, trace_hook=None):
    """Frame k is due at start + k / rate and offered then, or at once when
    the system is behind; its latency runs from its due time to its pose.
    Every frame due in the window is served before the flush."""
    lat, backlog, returned, late = [], [], [], []
    t_start = time.perf_counter()
    for k, frame in enumerate(pool):
        due = t_start + k / rate
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
        if trace_hook is not None:
            trace_hook(k)
        late.append(time.perf_counter() - due)
        res = sut.process(system, frame, traffic.stamp(k))
        lat.append(time.perf_counter() - due)
        backlog.append(sut.backlog(system))
        returned.append(res)
    if trace_hook is not None:
        trace_hook(len(pool), last=True)
    system.flush()
    window = time.perf_counter() - t_start
    return {"latency_s": lat, "window_s": window, "backlog": backlog, "results": returned,
            "late_s": max(late)}


class Tracer:
    """Profiles frames [start, start + n) of the window (fewer where the
    window ends first) with ``torch.profiler`` and records the k-NN calls
    made in them."""

    def __init__(self, sut, start, n, device):
        self.sut, self.start, self.stop, self.device = sut, start, start + n, device
        self.prof = self.knn = None
        self.t = [None, None]
        self.frames = 0

    def __call__(self, k, last=False):
        from torch.profiler import ProfilerActivity, profile

        if k == self.start and self.prof is None and not last:
            sync(self.device)
            self.knn = self.sut.KnnShapes().__enter__()
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.t[0] = time.perf_counter_ns()
        elif self.prof is not None and self.t[1] is None and (k == self.stop or last):
            sync(self.device)
            self.t[1] = time.perf_counter_ns()
            self.prof.__exit__(None, None, None)
            self.knn.__exit__(None, None, None)
            self.frames = k - self.start

    def events(self):
        """Kernel, copy and runtime events of the traced frames, reduced to
        plain tuples (name, start ns, duration ns, thread)."""
        out = {"device": [], "runtime": [], "cpu": []}
        for e in self.prof.profiler.kineto_results.events():
            kind = str(e.device_type())
            rec = (e.name(), e.start_ns(), e.duration_ns(), e.start_thread_id())
            if kind.endswith("CUDA"):
                out["device"].append(rec)
            elif e.name().startswith(("cuda", "cu")) and not e.name().startswith("cudnn"):
                out["runtime"].append(rec)
            else:
                out["cpu"].append(rec)
        return out


# -- the run ------------------------------------------------------------------


def run(argv, t_process_start, device=None, root=ROOT, control=False):
    """One run; ``device`` None takes the card and refuses to run without
    one (a test passes a CPU device, and its own ``root``, to drive the rest
    of a run). ``control`` adds the control's readings of the same payload
    (``benchmark/control.py``; the benchmark's own runs leave it out)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, config, mix, limits, e2e, layer, base = load_spec(args.workload, Path(root))
    # build and kernel caches of the program stay inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
    device = torch.device(device)
    cuda = device.type == "cuda"
    from . import sut, traffic as traffic_mod
    from .reference import check

    n_frames = traffic_mod.frames_needed(mix, args.seconds)
    tr = traffic_mod.Traffic(mix, config["sensor"], args.seed, device, n_frames)
    tmp = tempfile.TemporaryDirectory(prefix="perfcell-")
    storage = os.path.join(tmp.name, "keyframes")

    # -- set-up -----------------------------------------------------------------
    setup_poses = {}  # frame -> odometry pose returned in set-up
    if mix["setup"] == "warmup":
        warm = sut.build(config, device, os.path.join(tmp.name, "warmup"))
        sut.seed_velocity(warm, tr.initial_velocity())
        for k in range(mix["warmup_frames"]):
            sut.process(warm, tr.frame(k), tr.stamp(k))
        warm.flush()
        sut.warm_solver(warm)
        sut.close(warm)
        del warm
        first = 0
        system = sut.build(config, device, storage)
        sut.seed_velocity(system, tr.initial_velocity())
        verified = sut.record_loop_verifications(system)
        located = sut.record_localizations(system)
        filters = sut.record_filters(system)
    elif mix["setup"] == "first_loop":
        system = sut.build(config, device, storage)
        sut.seed_velocity(system, tr.initial_velocity())
        verified = sut.record_loop_verifications(system)
        located = sut.record_localizations(system)
        filters = sut.record_filters(system)
        sut.warm_solver(system)
        first = None
        for k in range(mix["setup_max_frames"]):
            setup_poses[k] = sut.process(system, tr.frame(k), tr.stamp(k)).odom_pose
            system.flush()
            if sut.localizing(system):
                first = k + 1
                break
        if first is None:
            print(f"no loop closed in {mix['setup_max_frames']} set-up frames", file=sys.stderr)
            return 4
    else:
        raise ValueError(f"unknown set-up {mix['setup']!r}")
    # every frame of the window with its IMU window, made before it opens
    if mix["loop"] == "open":
        pool = [tr.frame(k) for k in range(n_frames)]
    else:
        pool = [tr.frame(first + k) for k in range(mix["pool_frames"])]
    stages_before = sut.stage_samples(system)
    gc.collect()
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_process_start

    # -- window -------------------------------------------------------------------
    tracer = Tracer(sut, TRACE_SKIP, TRACE_FRAMES, device) if args.trace else None
    # the frames whose tracker state the check follows, drawn from the seed
    samp = check_sample(args.seed, mix, len(pool))
    states, after = {}, {}

    def hook(k, last=False):
        if tracer is not None:
            tracer(k, last)
        if k - 1 in samp:
            after[k - 1] = sut.tracker_before(system)
        if k in samp and not last:
            states[k] = sut.tracker_before(system)

    if mix["loop"] == "open":
        w = open_window(sut, system, tr, pool, mix["rate_fps"], hook)
    else:
        w = closed_window(sut, system, tr, pool, first, args.seconds, hook)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return 5

    # -- what the check needs, then the program is freed ---------------------------
    n = len(w["results"])
    stages_after = sut.stage_samples(system)
    payload = make_payload(sut, system, config, tr, pool, first, w, states, after, setup_poses,
                           verified, located, filters, args.seed, device)
    sut.close(system)
    del system, states, after, filters
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ctx = {"n_frames": n, "window_s": w["window_s"], "backlog": w["backlog"],
           "stages": {k: v[len(stages_before.get(k, [])):] for k, v in stages_after.items()}}
    metrics = {}
    if args.trace:
        ctx["trace"] = tracer.events()
        ctx["trace_frames"] = tracer.frames
        ctx["trace_window_s"] = (tracer.t[1] - tracer.t[0]) * 1e-9
        ctx["knn_calls"] = tracer.knn.calls()
        for m in layer:
            v = load_reader(base, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        lat = latency_stats(w["latency_s"])
        values = {"setup_s": setup_s, "frames_per_s": n / w["window_s"], **lat}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    if mix["loop"] == "open":
        print(f"open loop: the generator offered frames up to {w['late_s']:.4f} s after they were "
              f"due", file=sys.stderr)

    # -- correct ---------------------------------------------------------------------
    t_check = time.perf_counter()
    numbers = check.numbers(payload)
    print(f"the reference took {time.perf_counter() - t_check:.1f} s; it redid "
          f"{len(payload['frames'])} frames ({len(payload['filters'])} filter steps held), "
          f"{len(payload['stored'])} stored keyframes, "
          f"{len(payload['loops'])} loop verifications and {len(payload['locs'])} of the window's "
          f"{payload['localizations']} localizations", file=sys.stderr)
    compared = {name: {"value": numbers.get(name), "limit": lim} for name, lim in limits.items()}
    missing = [k for k, v in compared.items() if v["value"] is None]
    correct = not missing and all(v["value"] <= v["limit"] for v in compared.values())
    for name, v in compared.items():
        print(f"check {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": n, "failed": 0, "metrics": metrics,
              "device": device_info}
    if args.trace:
        dev_ev = ctx["trace"]["device"]
        device_info["busy_s"] = union_seconds([(s, d) for _, s, d, _ in dev_ev])
        device_info["window_s"] = ctx["trace_window_s"]
        result["breakdown"] = breakdown(ctx["trace"])
    if control:
        result["control"] = check.numbers(payload, control=True)
    result["check"] = compared
    tmp.cleanup()
    print(json.dumps(result))
    return 0


def check_sample(seed, mix, pool_len):
    """Window frames whose registration the reference follows: drawn from
    the seed among the first frames every window reaches."""
    import numpy as np

    span = min(pool_len, mix.get("check_span", 60))
    rng = np.random.default_rng(int(seed) & (2**63 - 1))
    return set(int(k) for k in rng.choice(span, size=mix.get("check_frames", 4), replace=False))


def make_payload(sut, system, config, tr, pool, first, w, states, after, setup_poses, verified,
                 located, filters, seed, device):
    """The check's inputs, on the host: the scans, their sweep times and IMU
    windows (by frame, taken from the window's pool or made again where it
    lacks them), every odometry pose the system returned since its first
    frame, the tracker states of the sampled frames, where the system has an
    IMU filter its state before and after each frame up to the last sampled
    one (the frames whose deskewed features the sampled frames' rings hold),
    the stored keyframes (those stored in the window, or, where the window
    stored none, in set-up), the pose graph after the flush, the accepted
    loop verifications and a sample of the window's localizations."""
    import numpy as np

    first = first or 0
    rendered = {}

    def frame_of_course(frame):
        if 0 <= frame - first < len(pool):
            return pool[frame - first]
        if frame not in rendered:
            rendered[frame] = tr.frame(frame)
        return rendered[frame]

    def scan_of(frame):
        return frame_of_course(frame)[0][:2]

    def sweep_of(frame):
        return frame_of_course(frame)[0][2][:, 0]

    def imu_of(frame):
        return frame_of_course(frame)[1]

    returned = {first + k: r.odom_pose for k, r in enumerate(w["results"])}
    odometry = {**setup_poses, **returned}
    frames = []
    for k, st in sorted(states.items()):
        if k < len(w["results"]):
            frames.append({"frame": first + k, "pose": w["results"][k].odom_pose,
                           **sut.tracker_state_payload(st, after.get(k))})
    held = {}
    if filters is not None and frames:
        last = max(f["frame"] for f in frames)
        for stamp, (before, after_f) in filters.items():
            frame = int(round(stamp / tr.stamp(1)))
            if frame <= last:
                held[frame] = {"before": sut.filter_payload(before),
                               "after": sut.filter_payload(after_f)}
    db = sut.store(system)
    n = db["n"]
    frame_of = np.rint(db["stamps"] / tr.stamp(1)).astype(int)

    rng = np.random.default_rng((int(seed) + 1) & (2**63 - 1))
    in_window = [i for i in range(n) if frame_of[i] in returned]
    if not in_window:
        returned = dict(setup_poses)
        in_window = [i for i in range(n) if frame_of[i] in returned]
    stored = []
    for i in sorted(rng.choice(in_window, size=min(3, len(in_window)), replace=False).tolist()
                    if in_window else []):
        stored.append({"frame": int(frame_of[i]), "pose_returned": returned[frame_of[i]],
                       "pose_stored": db["odom"][i],
                       "edge": (np.array(db["edge_xyz"][i]), np.array(db["edge_mask"][i])),
                       "surf": (np.array(db["surf_xyz"][i]), np.array(db["surf_mask"][i]))})
    graph = None if len(db["eij"]) == 0 else {k: db[k] for k in ("eij", "z", "sqrtw", "loop")}
    if graph is not None:
        graph["poses"] = db["map"]
        graph["odom"] = db["odom"]
    loops = []
    found = {(r["cand"], r["new_id"]): r for r in verified}
    edges = [e for e in np.nonzero(db["loop"])[0]
             if tuple(int(v) for v in db["eij"][e]) in found]
    for e in sorted(rng.choice(edges, size=min(2, len(edges)), replace=False).tolist()
                    if edges else []):
        r = found[tuple(int(v) for v in db["eij"][e])]
        loops.append({"scan": scan_of(frame_of[r["new_id"]]), "init": r["init"], "pose": r["pose"],
                      "neighbours": [(scan_of(frame_of[m]), p) for m, p in zip(r["ids"], r["poses"])]})
    locs = []
    window_locs = [r for r in located if r["stamp"] >= tr.stamp(first) - 1e-6]
    lrng = np.random.default_rng((int(seed) + 2) & (2**63 - 1))
    for j in sorted(lrng.choice(len(window_locs), size=min(LOC_SAMPLES, len(window_locs)),
                                replace=False).tolist() if window_locs else []):
        r = window_locs[j]
        m = r["map_poses"].shape[0]
        locs.append({"frame": int(round(r["stamp"] / tr.stamp(1))), "pred": r["pred"],
                     "pose": r["pose"], "map_poses": r["map_poses"],
                     "keyframe_frames": frame_of[:m].tolist(),
                     "keyframe_masks": [(np.array(db["edge_mask"][i]), np.array(db["surf_mask"][i]))
                                        for i in range(m)]})
    return {"device": str(device), "config": check_config(config), "scan_of": scan_of,
            "sweep_of": sweep_of, "imu_of": imu_of, "filters": held,
            "filter_start_v": tr.initial_velocity(), "stamp": tr.stamp(1),
            "odometry": odometry, "frames": frames, "stored": stored, "graph": graph,
            "loops": loops, "locs": locs, "localizations": len(window_locs)}


# the IMU-aided step's constants (see check_config)
LIO_DEFAULTS = {
    "eskf": {"acc_noise": 1e-2, "gyro_noise": 1e-3, "acc_bias_noise": 1e-4,
             "gyro_bias_noise": 1e-5, "gravity": 9.81, "init_pos_std": 0.1, "init_vel_std": 0.1,
             "init_att_std": 0.05, "init_ba_std": 0.05, "init_bg_std": 0.01},
    "reg_pos_std": 0.05, "reg_rot_std": 0.01, "max_velocity": 30.0, "max_bias": 1.0,
    "gates": {"max_motion_trans": 10.0, "max_motion_rot": 1.5, "motion_floor": 2.0,
              "motion_gate_k": 3.0, "gate_reopen_after": 3, "pred_trust_k": 0.3,
              "pred_trust_floor": 0.5},
}


def check_config(config):
    """The parameters the reference needs, from the configuration's system
    block; what the block leaves out takes the system's documented defaults
    (the loop verifier's rough stage: 8 iterations, a 4 m gate, huber 2 m,
    and its refine stage: 10 iterations, a 1 m gate; localization: 8
    iterations, a 2 m gate, the 10 nearest keyframes; the tracker's local map
    of 20 scans, downsampled at 0.25 m into 8192 edge and 16384 surf voxels,
    carved where probation is on; odometry edges of variance 1e-4 rad² and
    0.0025 m²; the graph's huber scale 10 on the whitened norm). With
    ``use_imu`` the odometry map is not carved (the IMU-aided tracker gets no
    range image) and ``lio`` holds the IMU-aided step's constants, the
    system's own (``lio/lio_tracker.py``, ``estimator/eskf.py``,
    ``tracker/tracker.py``, ``system/ml_system.py``): the filter's noise
    densities, initial deviations and gravity; the registration's
    measurement noise; the failure reset's limits; the motion gates, with the
    prediction-trust gate at 0.3 of the smoothed speed under an IMU."""
    s = config["system"]
    pre = s.get("preprocess", {})
    loop = s.get("loop", {})
    refine = dict({"max_iters": 10, "max_corr_dist": 1.0, "degen_rel": 0.01},
                  **loop.get("refine_params", {}))
    rough = dict({"max_iters": 8, "max_corr_dist": 4.0, "huber_delta": 2.0, "degen_rel": 0.01},
                 **loop.get("rough_params", {}))
    rot = s.get("map_update_rot")
    if rot is None:
        rot = math.radians(s["map_update_rot_deg"]) if "map_update_rot_deg" in s else 0.1
    insert = {"trans": s.get("map_update_trans", 0.3), "rot": rot, "dt": s.get("map_update_dt", 10.0)}
    life = s.get("lifelong", {})
    localization = dict({"max_iters": 8, "max_corr_dist": 2.0}, **life.get("localization_params", {}))
    odom_noise = [life.get("odom_noise_rot", 1e-4)] * 3 + [life.get("odom_noise_trans", 0.0025)] * 3
    return {"feature": s.get("feature", {}), "min_range": pre.get("min_range", 1.0),
            "map_insert": insert, "window": s.get("tracker_window", 20),
            "map_voxel": 0.25, "map_capacity": (8192, 16384),
            "probation": bool(s.get("dynamic_probation", False)),
            "carve": bool(s.get("dynamic_probation", False)) and not s.get("use_imu", False),
            "lio": LIO_DEFAULTS if s.get("use_imu", False) else None,
            "max_range": pre.get("max_range", 60.0), "registration": s.get("registration", {}),
            "loop_rough": rough, "loop_refine": refine, "localization": localization,
            "localization_knn": life.get("localization_knn", 10), "odom_noise": odom_noise,
            "graph_delta": life.get("pose_graph", {}).get("kernel_delta", 10.0)}


# -- trace reduction ------------------------------------------------------------


def union_seconds(intervals):
    """Seconds covered by the union of (start ns, duration ns) intervals."""
    total, end = 0, None
    for s, d in sorted(intervals):
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-9


def idle_gaps(intervals):
    """(start ns, length ns) of the gaps between the union's pieces."""
    gaps, end = [], None
    for s, d in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s - end))
        end = s + d if end is None else max(end, s + d)
    return gaps


def short_name(name):
    """A kernel's name without its template and argument lists."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0), default=len(name))
    return name[:cut]


# profiler bookkeeping that runs in the host's gaps only because it traces
PROFILER_OWN = ("Activity Buffer Request",)


def breakdown(trace, top=10):
    """The device operations that took most time, and the longest idle gaps
    named by the innermost host operation running at the gap's middle."""
    by_name = {}
    for name, _, d, _ in trace["device"]:
        by_name[short_name(name)] = by_name.get(short_name(name), 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps([(s, d) for _, s, d, _ in trace["device"]]), key=lambda g: -g[1])[:top]
    host = sorted((e for e in trace["cpu"] + trace["runtime"] if e[0] not in PROFILER_OWN),
                  key=lambda e: e[1])
    named = []
    for g0, gl in gaps:
        mid = g0 + gl // 2
        inner = None
        for name, s, d, _ in host:
            if s > mid:
                break
            if s + d >= mid and (inner is None or s >= inner[1]):
                inner = (name, s)
        named.append([inner[0] if inner else "python (no op)", gl * 1e-9])
    return {"device_ops": [[n, d * 1e-9] for n, d in ops], "idle_gaps": named}


def main(argv=None, t_process_start=None):
    t0 = time.perf_counter() if t_process_start is None else t_process_start
    return run(sys.argv[1:] if argv is None else argv, t0)
