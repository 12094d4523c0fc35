"""Carry state over from the reference package.

``tracker_state_from_numpy`` builds this package's ``TrackerState`` from the
reference's, handed over as numpy arrays::

    jax_state = jax.tree.map(np.asarray, jax_state)   # in the JAX process
    state = tracker_state_from_numpy(jax_state._asdict(), device="cuda")

so the port resumes a sequence exactly where the reference left it. The
nested map states may be mappings or objects with the same field names
(``LocalMapState`` tuples, ``PointBatch``-like objects with
``xyz``/``mask``/``attr``).

``keyframe_db_from_numpy`` and ``backend_state_from_numpy`` do the same for
the lifelong backend: the reference database's arrays and the backend's mode,
``odom2map``, ``last_stamp`` and ``_pending``, so that both packages start a
localization or a relocalization from the same map::

    fields = {k: np.asarray(getattr(jax_db, k)) for k in KEYFRAME_DB_FIELDS}
    fields.update(n_keyframes=jax_db.n_keyframes, n_edges=jax_db.n_edges,
                  edge_capacity=jax_db.edge_capacity, surf_capacity=jax_db.surf_capacity)
    db = keyframe_db_from_numpy(fields, device="cuda")

``eskf_state_from_numpy``, ``preintegrated_from_numpy``,
``lio_states_from_numpy`` and ``lio_tracker_from_numpy`` carry the IMU stack
over: an ``EskfState``, a ``PreintegratedImu``, the ``LioStates`` of a LIO
factor-graph window, and a whole ``LioTracker`` mid-run (its tracker state,
filter, ``prev_pose`` and scan count), so that a reference ``LioTracker`` or
``FactorGraphLio`` continues in the port::

    lio = lio_tracker_from_numpy(config, jax.tree.map(np.asarray, ref.tracker_state),
                                 jax.tree.map(np.asarray, ref.eskf), ref.prev_pose,
                                 ref.n_scans, failures=ref.failures, device="cuda")

``handeye_state_from_numpy`` carries a hand-eye pair store over, and
``submap_partition_from_numpy`` a Schur solve's partition (host numpy in both
packages, so the fields are taken as they are)::

    state = handeye_state_from_numpy(jax.tree.map(np.asarray, ref_state), device="cuda")

Nothing of the reference is imported here.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .backend.keyframe_db import KeyframeDatabase
from .backend.lifelong import LifelongBackend, WorkMode
from .backend.lio_graph import LioStates
from .calibration.handeye import HandEyeState
from .common.pointcloud import PointBatch
from .estimator.eskf import EskfState
from .estimator.preintegration import PreintegratedImu
from .lio.lio_tracker import LioConfig, LioTracker
from .parallel.schur import SubmapPartition
from .tracker.localmap import LocalMapState
from .tracker.tracker import TrackerState

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unexpected dtype {a.dtype} in the tracker state")
    return torch.as_tensor(np.array(a), dtype=_DTYPES[a.dtype], device=device)


def _local_map(obj, device) -> LocalMapState:
    return LocalMapState(*(_tensor(_field(obj, f), device) for f in LocalMapState._fields))


def _point_batch(obj, device) -> PointBatch:
    return PointBatch(*(_tensor(_field(obj, f), device) for f in ("xyz", "mask", "attr")))


def tracker_state_from_numpy(state, device="cuda") -> TrackerState:
    """This package's ``TrackerState`` from the reference's, given as a
    mapping (or named tuple) of numpy arrays with the same field names."""
    if not isinstance(state, Mapping):
        state = state._asdict()
    missing = set(TrackerState._fields) - set(state)
    if missing:
        raise KeyError(f"tracker state lacks {sorted(missing)}")
    out = {}
    for name in TrackerState._fields:
        v = state[name]
        if name in ("edge_map", "surf_map"):
            out[name] = _local_map(v, device)
        elif name in ("edge_flat", "surf_flat"):
            out[name] = _point_batch(v, device)
        else:
            out[name] = _tensor(v, device)
    return TrackerState(**out)


# per-keyframe and per-edge arrays of the reference's KeyframeDatabase
KEYFRAME_DB_FIELDS = (
    "stamps", "odom_poses", "map_poses", "edge_xyz", "edge_mask", "surf_xyz", "surf_mask",
    "sc", "ring_keys", "gnss_pos", "gnss_valid",
)
KEYFRAME_DB_EDGE_FIELDS = ("eij", "ez", "esqrtw", "eloop")


def keyframe_db_from_numpy(fields, device="cuda", mirror_min_cap: int = 512) -> KeyframeDatabase:
    """This package's ``KeyframeDatabase`` from the reference's arrays
    (``KEYFRAME_DB_FIELDS``, ``KEYFRAME_DB_EDGE_FIELDS``, ``n_keyframes``,
    ``n_edges``; the capacities are read from the cloud arrays when
    ``edge_capacity`` / ``surf_capacity`` are not given). Rows beyond the
    counts are ignored; dtypes are kept, so both stores hold the same bytes."""
    missing = (set(KEYFRAME_DB_FIELDS) | set(KEYFRAME_DB_EDGE_FIELDS)
               | {"n_keyframes", "n_edges"}) - set(fields)
    if missing:
        raise KeyError(f"keyframe database lacks {sorted(missing)}")
    n, e = int(fields["n_keyframes"]), int(fields["n_edges"])
    sc = np.asarray(fields["sc"])
    db = KeyframeDatabase(
        edge_capacity=int(fields.get("edge_capacity", np.asarray(fields["edge_xyz"]).shape[1])),
        surf_capacity=int(fields.get("surf_capacity", np.asarray(fields["surf_xyz"]).shape[1])),
        initial_keyframes=max(n, 1),
        sc_rings=sc.shape[1],
        sc_sectors=sc.shape[2],
        mirror_min_cap=mirror_min_cap,
        device=device,
    )
    for name in KEYFRAME_DB_FIELDS:
        dst = getattr(db, name)
        src = np.asarray(fields[name])[:n]
        if src.shape[1:] != dst.shape[1:]:
            raise ValueError(f"{name}: rows of shape {src.shape[1:]}, expected {dst.shape[1:]}")
        dst[:n] = src
    db.n_keyframes = n
    db._ensure_edge_capacity(max(e, 1))
    for name in KEYFRAME_DB_EDGE_FIELDS:
        getattr(db, name)[:e] = np.asarray(fields[name])[:e]
    db.n_edges = e
    return db


def backend_state_from_numpy(backend: LifelongBackend, state) -> LifelongBackend:
    """Set a backend's FSM state from the reference backend's: ``mode`` (a
    name, a value or an enum member with one), ``odom2map``, ``last_stamp``
    and ``_pending``. Returns the backend."""
    missing = {"mode", "odom2map", "last_stamp", "_pending"} - set(state)
    if missing:
        raise KeyError(f"backend state lacks {sorted(missing)}")
    mode = state["mode"]
    mode = getattr(mode, "name", mode)
    backend.mode = WorkMode[mode] if isinstance(mode, str) else WorkMode(int(mode))
    backend.odom2map = np.asarray(state["odom2map"], np.float32).copy()
    backend.last_stamp = float(state["last_stamp"])
    backend._pending = int(state["_pending"])
    return backend


def _fields(obj, cls):
    """The fields of ``cls`` from a mapping or named tuple, every one present."""
    if not isinstance(obj, Mapping):
        obj = obj._asdict()
    missing = set(cls._fields) - set(obj)
    if missing:
        raise KeyError(f"{cls.__name__} lacks {sorted(missing)}")
    return [obj[name] for name in cls._fields]


def eskf_state_from_numpy(state, device="cuda") -> EskfState:
    """This package's ``EskfState`` from the reference's (a mapping or named
    tuple of float32 arrays: p, v, q, ba, bg, cov)."""
    return EskfState(*(_tensor(v, device) for v in _fields(state, EskfState)))


def preintegrated_from_numpy(pre, device="cuda") -> PreintegratedImu:
    """This package's ``PreintegratedImu`` from the reference's."""
    return PreintegratedImu(*(_tensor(v, device) for v in _fields(pre, PreintegratedImu)))


def lio_states_from_numpy(states, device="cuda") -> LioStates:
    """This package's ``LioStates`` (a padded LIO window) from the reference's."""
    return LioStates(*(_tensor(v, device) for v in _fields(states, LioStates)))


def lio_tracker_from_numpy(config: LioConfig, tracker_state, eskf, prev_pose, n_scans: int,
                           failures: int = 0, device="cuda") -> LioTracker:
    """A ``LioTracker`` that continues the reference's mid-run: its
    ``TrackerState`` and ``EskfState`` (numpy leaves, see
    :func:`tracker_state_from_numpy`), ``prev_pose`` (7,), the number of scans
    it has processed and its failure count."""
    lio = LioTracker(config, device=device)
    lio.tracker_state = tracker_state_from_numpy(tracker_state, device=device)
    lio.eskf = eskf_state_from_numpy(eskf, device=device)
    lio.prev_pose = _tensor(np.asarray(prev_pose, np.float32), device)
    lio.n_scans = int(n_scans)
    lio.failures = failures
    return lio


def handeye_state_from_numpy(state, device="cuda") -> HandEyeState:
    """This package's ``HandEyeState`` from the reference's (a mapping or
    named tuple: the pair store, its mask, write index and count)."""
    return HandEyeState(*(_tensor(v, device) for v in _fields(state, HandEyeState)))


def submap_partition_from_numpy(part) -> SubmapPartition:
    """This package's ``SubmapPartition`` from the reference's: the same
    host numpy fields, copied."""
    return SubmapPartition(*(v if isinstance(v, int) else np.array(v)
                             for v in _fields(part, SubmapPartition)))
