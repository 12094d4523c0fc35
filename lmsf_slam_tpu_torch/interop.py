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

Nothing of the reference is imported here.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .backend.keyframe_db import KeyframeDatabase
from .backend.lifelong import LifelongBackend, WorkMode
from .common.pointcloud import PointBatch
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
