"""Keyframe / pose-graph database with a device-resident search mirror.

Counterpart of ``lmsf_slam_tpu/backend/keyframe_db.py`` without persistence:
vertices + between-edges, per-keyframe feature clouds, optimized positions
and scan-context descriptors. The store is array-of-structs numpy on the
host, growing by doubling; everything searchable (positions, descriptors,
ring keys) and the clouds themselves are mirrored on ``device``, so loop and
relocalization candidate search and the local-map assembly run on the card
with no per-query upload.

Keyframe clouds are stored in the **sensor frame** with their odometry and
optimized (map-frame) poses; local maps are assembled with the *current*
optimized poses, so graph corrections propagate to every later localization
query.

The mirror is brought up to date lazily (:meth:`KeyframeDatabase._mirror_sync`)
from the host store, so both always hold the same bytes: a whole upload when
its capacity grows (powers of two from ``mirror_min_cap``), else the new
keyframes' rows, the poses after an optimize, and the masks of carved rows.
Rows are written in place (``mirror[i] = row``); the reference's
``dynamic_update_slice`` clamps an out-of-range start where a torch slice
raises, so the append asserts its row lies below the capacity.

``save``, ``load`` and a ``storage_dir`` (disk-backed payloads) are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..common import se3
from ..common.pointcloud import PointBatch
from ..ops import scancontext

_NO_PERSISTENCE = (
    "the port's KeyframeDatabase has no persistence yet (save/load and "
    "disk-backed storage_dir: ROADMAP.md section 1, item 10)"
)


class GraphArrays(NamedTuple):
    """Padded device views of the graph for the batch GN solver."""

    poses: torch.Tensor  # (V, 7)
    vmask: torch.Tensor  # (V,)
    edges_ij: torch.Tensor  # (E, 2)
    edges_z: torch.Tensor  # (E, 7)
    edges_sqrtw: torch.Tensor  # (E, 6)
    emask: torch.Tensor  # (E,)
    erobust: torch.Tensor  # (E,) — robust kernel applies (loop edges)


def _grow(arr: np.ndarray, new_cap: int) -> np.ndarray:
    out = np.zeros((new_cap,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _sc_ringkey(exyz, emask, sxyz, smask, rings: int, sectors: int, ecap: int, scap: int):
    """Scan-context + ring key of a keyframe's feature clouds. Clouds are
    clipped to the database's storage capacities FIRST so the descriptor
    describes exactly the points the DB keeps."""
    both = PointBatch(
        torch.cat([exyz[:ecap], sxyz[:scap]]),
        torch.cat([emask[:ecap], smask[:scap]]),
    )
    sc = scancontext.make_scan_context(both, rings=rings, sectors=sectors)
    return sc, scancontext.ring_key(sc)


def _gather_local_map(exyz, emask, sxyz, smask, poses, ids, idmask):
    """Fixed-K padded local-map assembly, entirely device-resident.

    Gathers K keyframes' clouds from the resident mirror, transforms them
    with their CURRENT optimized poses and flattens: static shapes, no cloud
    is copied to the card for a localization or loop query."""
    p = poses[ids]  # (K, 7)
    ew = se3.pose_apply(p, exyz[ids])  # (K, E, 3)
    sw = se3.pose_apply(p, sxyz[ids])
    em = emask[ids] & idmask[:, None]
    sm = smask[ids] & idmask[:, None]
    return ew.reshape(-1, 3), em.reshape(-1), sw.reshape(-1, 3), sm.reshape(-1)


def _mirror_knn_ids(pos, valid, query, max_id: int, k: int):
    """Masked k-NN over the device position mirror: (ids (k,), squared
    distances (k,), inf where fewer than k rows qualify), nearest first,
    the lowest id first among equals."""
    d2 = torch.sum((pos - query[None, :]) ** 2, dim=-1)
    ok = valid & (torch.arange(pos.shape[0], device=pos.device) < max_id)
    d2 = torch.where(ok, d2, torch.inf)
    d2, ids = torch.sort(d2, stable=True)
    return ids[:k], d2[:k]


def _knn_gather_local_map(exyz, emk, sxyz, smk, poses, pos, valid, query, max_id: int, k: int):
    """kNN over the position mirror + fixed-K local-map gather: the ids
    never leave the device."""
    ids, d2 = _mirror_knn_ids(pos, valid, query, max_id, k)
    idmask = torch.isfinite(d2)
    ids = torch.where(idmask, ids, 0)
    return _gather_local_map(exyz, emk, sxyz, smk, poses, ids, idmask)


def _mirror_knn(pos, valid, query, max_id: int, k: int):
    """Masked k-NN over the device position mirror: (ids, distances)."""
    ids, d2 = _mirror_knn_ids(pos, valid, query, max_id, k)
    return ids, torch.sqrt(torch.clamp(d2, min=0.0))


class KeyframeDatabase:
    """Append-only keyframe + pose-graph store.

    Capacities grow by doubling (amortized O(1)).
    """

    def __init__(
        self,
        edge_capacity: int = 1024,
        surf_capacity: int = 4096,
        initial_keyframes: int = 256,
        sc_rings: int = scancontext.RINGS,
        sc_sectors: int = scancontext.SECTORS,
        storage_dir: str | None = None,
        mirror_min_cap: int = 512,
        device="cuda",
    ):
        """``mirror_min_cap``: floor of the device mirror's row capacity; the
        mirror is re-uploaded whole only when the database outgrows it.
        ``device``: where the mirror lives and the descriptors are computed."""
        if storage_dir is not None:
            raise NotImplementedError(_NO_PERSISTENCE)
        self.edge_capacity = edge_capacity
        self.surf_capacity = surf_capacity
        self.sc_shape = (sc_rings, sc_sectors)
        self.storage_dir = None
        self.mirror_min_cap = mirror_min_cap
        self.device = torch.device(device)
        n = initial_keyframes
        self.n_keyframes = 0
        self.stamps = np.zeros(n, np.float64)
        self.odom_poses = np.zeros((n, 7), np.float32)
        self.map_poses = np.zeros((n, 7), np.float32)
        self.edge_xyz = np.zeros((n, edge_capacity, 3), np.float32)
        self.edge_mask = np.zeros((n, edge_capacity), bool)
        self.surf_xyz = np.zeros((n, surf_capacity, 3), np.float32)
        self.surf_mask = np.zeros((n, surf_capacity), bool)
        self.sc = np.zeros((n,) + self.sc_shape, np.float32)
        self.ring_keys = np.zeros((n, sc_rings), np.float32)
        # optional per-keyframe GNSS observation (map/ENU frame)
        self.gnss_pos = np.zeros((n, 3), np.float32)
        self.gnss_valid = np.zeros(n, bool)
        # graph edges
        self.n_edges = 0
        self.eij = np.zeros((n, 2), np.int32)
        self.ez = np.zeros((n, 7), np.float32)
        self.esqrtw = np.zeros((n, 6), np.float32)
        # edge kind: False = odometry/sequential, True = loop closure —
        # drives the per-edge robust-kernel policy
        self.eloop = np.zeros(n, bool)
        # device-resident search mirror, appended incrementally
        self._mirror: dict | None = None
        self._pose_rev = 0  # bumped by update_poses → position mirror refresh
        # keyframes whose masks were carved since the last mirror sync —
        # their mirror rows are re-uploaded lazily (carving is rare)
        self._dirty_rows: set[int] = set()

    # -- insertion ----------------------------------------------------------

    def _ensure_kf_capacity(self, need: int):
        cap = self.stamps.shape[0]
        if need <= cap:
            return
        new = max(need, cap * 2)
        for name in (
            "stamps", "odom_poses", "map_poses", "edge_xyz", "edge_mask", "surf_xyz",
            "surf_mask", "sc", "ring_keys", "gnss_pos", "gnss_valid",
        ):
            setattr(self, name, _grow(getattr(self, name), new))

    def _ensure_edge_capacity(self, need: int):
        cap = self.eij.shape[0]
        if need <= cap:
            return
        new = max(need, cap * 2)
        self.eij = _grow(self.eij, new)
        self.ez = _grow(self.ez, new)
        self.esqrtw = _grow(self.esqrtw, new)
        self.eloop = _grow(self.eloop, new)

    def add_keyframe(
        self,
        stamp: float,
        odom_pose,
        map_pose,
        edge_pb: PointBatch,
        surf_pb: PointBatch,
        sc=None,
        gnss_pos=None,
    ) -> int:
        """Store a keyframe (clouds in sensor frame). Returns its id.

        ``sc`` may be precomputed; otherwise it is built here, on the clouds'
        device, from the concatenated feature clouds. The clouds (and the
        descriptor) come to the host for the store; the mirror takes its row
        from there at the next query.
        """
        i = self.n_keyframes
        self._ensure_kf_capacity(i + 1)
        self.stamps[i] = float(stamp)
        self.odom_poses[i] = np.asarray(odom_pose, np.float32)
        self.map_poses[i] = np.asarray(map_pose, np.float32)

        ne = min(edge_pb.xyz.shape[0], self.edge_capacity)
        ns = min(surf_pb.xyz.shape[0], self.surf_capacity)
        if sc is None:
            sc_d, rk_d = _sc_ringkey(
                edge_pb.xyz, edge_pb.mask, surf_pb.xyz, surf_pb.mask,
                self.sc_shape[0], self.sc_shape[1], ne, ns,
            )
        else:
            sc_d = torch.as_tensor(np.asarray(sc, np.float32), device=edge_pb.xyz.device)
            rk_d = scancontext.ring_key(sc_d)
        # two copies to the host: the float payload packed, and the masks
        floats = torch.cat([
            edge_pb.xyz[:ne].reshape(-1), surf_pb.xyz[:ns].reshape(-1),
            sc_d.reshape(-1), rk_d.reshape(-1),
        ]).to(torch.float32).cpu().numpy()
        masks = torch.cat([edge_pb.mask[:ne], surf_pb.mask[:ns]]).cpu().numpy()
        a, b = 3 * ne, 3 * (ne + ns)
        c = b + self.sc_shape[0] * self.sc_shape[1]
        self.edge_xyz[i, :ne] = floats[:a].reshape(ne, 3)
        self.surf_xyz[i, :ns] = floats[a:b].reshape(ns, 3)
        self.sc[i] = floats[b:c].reshape(self.sc_shape)
        self.ring_keys[i] = floats[c:]
        self.edge_mask[i, :ne] = masks[:ne]
        self.surf_mask[i, :ns] = masks[ne:]
        if gnss_pos is not None:
            self.gnss_pos[i] = np.asarray(gnss_pos, np.float32)
            self.gnss_valid[i] = True
        self.n_keyframes = i + 1
        return i

    def add_edge(self, i: int, j: int, z, noise=None, loop: bool = False) -> int:
        """Between-edge i→j with per-dim noise (σ²); information = 1/noise.
        Default noise is the odometry noise [1e-4×3 rot, 0.0025×3 trans].
        ``loop`` marks the edge as a loop closure: the graph solve applies
        its robust kernel only to loop edges."""
        if noise is None:
            noise = np.array([1e-4] * 3 + [0.0025] * 3)  # [rot, trans] order
        e = self.n_edges
        self._ensure_edge_capacity(e + 1)
        self.eij[e] = (i, j)
        self.ez[e] = np.asarray(z, np.float32)
        self.esqrtw[e] = 1.0 / np.sqrt(np.asarray(noise, np.float64))
        self.eloop[e] = bool(loop)
        self.n_edges = e + 1
        return e

    # -- queries ------------------------------------------------------------

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def keyframe_clouds(self, i: int) -> tuple[PointBatch, PointBatch]:
        return (
            PointBatch(self._to_device(self.edge_xyz[i]), self._to_device(self.edge_mask[i])),
            PointBatch(self._to_device(self.surf_xyz[i]), self._to_device(self.surf_mask[i])),
        )

    def positions(self) -> np.ndarray:
        return self.map_poses[: self.n_keyframes, 4:]

    def carve(self, i: int, edge_keep: np.ndarray, surf_keep: np.ndarray):
        """Permanently mask out points of keyframe ``i`` contradicted by
        later observations. Masks only ever shrink."""
        self.edge_mask[i] &= np.asarray(edge_keep, bool)
        self.surf_mask[i] &= np.asarray(surf_keep, bool)
        self._dirty_rows.add(int(i))

    def local_map(self, center_id: int, half_window: int = 5) -> tuple[PointBatch, PointBatch]:
        """Union of keyframes [center−h, center+h] transformed to map frame
        with current optimized poses: ids are clamped, never wrapped."""
        lo = max(0, center_id - half_window)
        hi = min(self.n_keyframes - 1, center_id + half_window)
        return self.local_map_ids(np.arange(lo, hi + 1))

    def local_map_ids(self, ids: np.ndarray) -> tuple[PointBatch, PointBatch]:
        """Union local map of an arbitrary keyframe id set, assembled from
        the host store (variable K; the clouds are copied to the device)."""
        ids = np.asarray(ids, np.int64)
        poses = self._to_device(self.map_poses[ids])  # (K,7)
        e_w = se3.pose_apply(poses, self._to_device(self.edge_xyz[ids]))  # (K,E,3)
        s_w = se3.pose_apply(poses, self._to_device(self.surf_xyz[ids]))
        edge = PointBatch(e_w.reshape(-1, 3), self._to_device(self.edge_mask[ids]).reshape(-1))
        surf = PointBatch(s_w.reshape(-1, 3), self._to_device(self.surf_mask[ids]).reshape(-1))
        return edge, surf

    def graph_arrays(self, pad_to_pow2: bool = True, pad_min: int = 0) -> GraphArrays:
        """Padded device arrays for ``optimize_pose_graph`` (gauge = vertex 0).

        ``pad_min`` floors the padded vertex/edge capacity, so the solver
        sees the same shapes while a young graph grows."""
        V = max(self.n_keyframes, 1)
        E = max(self.n_edges, 1)
        if pad_to_pow2:
            V = max(1 << (V - 1).bit_length(), pad_min)
            E = max(1 << (E - 1).bit_length(), pad_min)
        poses = np.zeros((V, 7), np.float32)
        poses[:, 0] = 1.0
        poses[: self.n_keyframes] = self.map_poses[: self.n_keyframes]
        vmask = np.zeros(V, bool)
        vmask[: self.n_keyframes] = True
        eij = np.zeros((E, 2), np.int32)
        ez = np.zeros((E, 7), np.float32)
        ez[:, 0] = 1.0
        esw = np.zeros((E, 6), np.float32)
        emask = np.zeros(E, bool)
        erob = np.zeros(E, bool)
        eij[: self.n_edges] = self.eij[: self.n_edges]
        ez[: self.n_edges] = self.ez[: self.n_edges]
        esw[: self.n_edges] = self.esqrtw[: self.n_edges]
        emask[: self.n_edges] = True
        erob[: self.n_edges] = self.eloop[: self.n_edges]
        return GraphArrays(*(self._to_device(a) for a in (poses, vmask, eij, ez, esw, emask, erob)))

    def update_poses(self, optimized: np.ndarray):
        """Write back optimized poses for all keyframes (full 7-dof)."""
        self.map_poses[: self.n_keyframes] = np.asarray(
            optimized[: self.n_keyframes], np.float32
        )
        self._pose_rev += 1

    def update_poses_range(self, start: int, optimized: np.ndarray):
        """Write back a contiguous pose slice ``[start, start+len)`` — the
        window-local incremental solve touches only its free window."""
        stop = min(start + optimized.shape[0], self.n_keyframes)
        self.map_poses[start:stop] = np.asarray(optimized[: stop - start], np.float32)
        self._pose_rev += 1

    # -- device search mirror -------------------------------------------------

    def _padded_poses(self, cap: int) -> torch.Tensor:
        poses = np.zeros((cap, 7), np.float32)
        poses[:, 0] = 1.0
        poses[: self.n_keyframes] = self.map_poses[: self.n_keyframes]
        return self._to_device(poses)

    def _mirror_sync(self) -> dict:
        """Bring the device mirror up to date. Costs: a full upload only on
        capacity growth (pow2, so ≤ log2 N times ever); otherwise one small
        host-to-device copy of the delta rows (descriptors + feature clouds
        of each new keyframe); a poses refresh after each optimize (a few
        KB); a mask re-upload for rows carved since the last sync."""
        n = self.n_keyframes
        cap = max(1 << max(n - 1, 0).bit_length(), self.mirror_min_cap)
        m = self._mirror
        if m is None or m["cap"] < cap:

            def padded(a):
                out = np.zeros((cap,) + a.shape[1:], a.dtype)
                out[:n] = a[:n]
                return self._to_device(out)

            poses = self._padded_poses(cap)
            m = dict(
                cap=cap,
                n=n,
                pose_rev=self._pose_rev,
                sc=padded(self.sc),
                rk=padded(self.ring_keys),
                poses=poses,
                pos=poses[:, 4:].contiguous(),
                exyz=padded(self.edge_xyz),
                emk=padded(self.edge_mask),
                sxyz=padded(self.surf_xyz),
                smk=padded(self.surf_mask),
                valid=torch.arange(cap, device=self.device) < n,
            )
            self._mirror = m
            self._dirty_rows.clear()
            return m
        if m["n"] < n:
            # the new keyframes' rows (usually exactly one), written in place
            lo, hi = m["n"], n
            assert hi <= m["cap"], "mirror append past its capacity"
            for key, src in (("sc", self.sc), ("rk", self.ring_keys), ("poses", self.map_poses),
                             ("exyz", self.edge_xyz), ("emk", self.edge_mask),
                             ("sxyz", self.surf_xyz), ("smk", self.surf_mask)):
                m[key][lo:hi] = self._to_device(src[lo:hi])
            m["pos"][lo:hi] = m["poses"][lo:hi, 4:]
            m["valid"] = torch.arange(m["cap"], device=self.device) < n
            self._dirty_rows -= set(range(lo, hi))
            m["n"] = n
        if m["pose_rev"] != self._pose_rev:
            m["poses"] = self._padded_poses(m["cap"])
            m["pos"] = m["poses"][:, 4:].contiguous()
            m["pose_rev"] = self._pose_rev
        if self._dirty_rows:
            for i in sorted(self._dirty_rows):
                if i >= m["n"]:
                    continue
                m["emk"][i] = self._to_device(self.edge_mask[i])
                m["smk"][i] = self._to_device(self.surf_mask[i])
            self._dirty_rows.clear()
        return m

    def local_map_ids_device(self, ids: np.ndarray, k: int) -> tuple[PointBatch, PointBatch]:
        """Device-resident fixed-K local map: pad ``ids`` to ``k`` entries
        (masked tail) and assemble the union map over the resident cloud
        mirror. Cost per call: a K-int upload; no per-call cloud transfer."""
        ids = np.asarray(ids, np.int32)[:k]
        idp = np.zeros(k, np.int64)
        idm = np.zeros(k, bool)
        idp[: ids.size] = ids
        idm[: ids.size] = True
        m = self._mirror_sync()
        ew, em, sw, sm = _gather_local_map(
            m["exyz"], m["emk"], m["sxyz"], m["smk"], m["poses"],
            self._to_device(idp), self._to_device(idm),
        )
        return PointBatch(ew, em), PointBatch(sw, sm)

    def local_map_knn_device(
        self, query_xyz, k: int, max_id: int | None = None
    ) -> tuple[PointBatch, PointBatch]:
        """kNN local map: the nearest keyframes by optimized position feed
        the cloud gather directly on the device (the ids never come to the
        host) — the localization-path replacement for ``nearest_ids`` +
        ``local_map_ids``."""
        m = self._mirror_sync()
        kk = min(k, m["cap"])
        ew, em, sw, sm = _knn_gather_local_map(
            m["exyz"], m["emk"], m["sxyz"], m["smk"], m["poses"], m["pos"], m["valid"],
            self._to_device(np.asarray(query_xyz, np.float32)),
            self.n_keyframes if max_id is None else int(max_id),
            kk,
        )
        return PointBatch(ew, em), PointBatch(sw, sm)

    def local_map_device(self, center_id: int, half_window: int = 5) -> tuple[PointBatch, PointBatch]:
        """Fixed-K device flavor of :meth:`local_map` (K = 2·half_window+1,
        ids clamped to the valid range, tail masked)."""
        lo = max(0, center_id - half_window)
        hi = min(self.n_keyframes - 1, center_id + half_window)
        return self.local_map_ids_device(np.arange(lo, hi + 1), 2 * half_window + 1)

    def descriptor_arrays(self):
        """(sc (N,R,S), ring_keys (N,R), valid (N,)) — persistent device
        arrays (pow2 capacity), appended incrementally after ``add_keyframe``."""
        m = self._mirror_sync()
        return m["sc"], m["rk"], m["valid"]

    def nearest_ids(
        self, query_xyz, k: int, max_id: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """k nearest keyframes to ``query_xyz`` by optimized position — one
        sort over the resident position mirror. Returns (ids, distances) as
        numpy, nearest first; entries with infinite distance are filtered
        out."""
        m = self._mirror_sync()
        kk = min(k, m["cap"])
        ids, d = _mirror_knn(
            m["pos"], m["valid"],
            self._to_device(np.asarray(query_xyz, np.float32)),
            self.n_keyframes if max_id is None else int(max_id),
            kk,
        )
        ids, d = ids.cpu().numpy(), d.cpu().numpy()
        keep = np.isfinite(d)
        return ids[keep], d[keep]

    # -- persistence ------------------------------------------------------------

    def save(self, path: str):
        raise NotImplementedError(_NO_PERSISTENCE)

    @classmethod
    def load(cls, path: str, storage_dir: str | None = None) -> "KeyframeDatabase":
        raise NotImplementedError(_NO_PERSISTENCE)
