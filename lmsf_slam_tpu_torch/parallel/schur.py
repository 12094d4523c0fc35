"""Submap-partitioned pose-graph solve by Schur-complement elimination.

Counterpart of ``lmsf_slam_tpu/parallel/schur.py``:

- vertices are partitioned into ``S`` contiguous **submaps** (keyframe order,
  so odometry edges stay internal);
- a vertex is a **separator** iff some edge couples it across submaps
  (submap boundaries and loop-closure endpoints);
- each Gauss-Newton step eliminates every submap's interior exactly with one
  batched dense Cholesky of (S, 6m, 6m), reduces onto the separator system,
  solves that small dense system, and back-substitutes.

The partition (:func:`partition_graph`) is host numpy, as in the reference;
the solve runs as torch ops on the device of ``poses``, or of the mesh. Over
a mesh (:mod:`.distributed`) each rank eliminates its contiguous S/size
submaps; the separator system and gradient, and the interior increments, are
summed over the mesh with an all-reduce where the reference ``psum``s them,
and every rank solves the separator system (replicated). S is rounded up to
a multiple of the mesh size. The all-reduce adds the ranks' float32 partial
sums in float64 on a card and rounds once. Without a mesh nothing of this
runs.

Two things differ from a literal translation, both for the card:

- ``torch.linalg.cholesky`` checks its result on the host; ``cholesky_ex``
  does not, and a factor whose ``info`` reports a failure is set to NaN with
  ``torch.where``, as XLA's Cholesky returns NaN for a matrix that is not
  positive definite;
- the scatters into the submap and separator systems add several blocks into
  one destination. ``index_add_`` on a card adds in no fixed order, so there
  they sum in float64 and round once, and two runs of a solve agree bit for
  bit (the CPU adds in index order, as ``segment_sum`` does).

The GN loop reads its ``done`` flag once an iteration and exits, where the
reference runs a fixed-length scan whose frozen iterations change nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..backend.pose_graph import (
    PoseGraphParams,
    PoseGraphStats,
    _clamp_step,
    _edge_res_jac,
    _edge_weights,
    edge_residual,
)
from ..common import se3
from .distributed import Mesh, allreduce

INT, SEP, DROP = 0, 1, 2


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class SubmapPartition(NamedTuple):
    """Host-precomputed index plumbing for the Schur solve (numpy)."""

    n_submaps: int  # S
    m: int  # interior variable slots per submap (padded)
    k: int  # separator slots adjacent to one submap (padded)
    n_sep: int  # global separator slots (padded)
    # per-(submap, edge-slot) edge gather list
    e_idx: np.ndarray  # (S, Emax) int32 — index into the global edge arrays
    e_mask: np.ndarray  # (S, Emax) bool
    # per-(submap, edge-slot, endpoint∈{i,j}) destination classes/slots
    cls: np.ndarray  # (S, Emax, 2) int8 — 0 interior, 1 separator, 2 fixed/drop
    loc: np.ndarray  # (S, Emax, 2) int32 — interior slot / LOCAL separator slot
    # separator plumbing
    sep_ids: np.ndarray  # (n_sep,) int32 — global vertex id per sep slot (-1 pad)
    sep_local2global: np.ndarray  # (S, k) int32 — local sep slot → global sep slot
    sep_l2g_mask: np.ndarray  # (S, k) bool
    # interior scatter-back
    int_ids: np.ndarray  # (S, m) int32 — global vertex id per interior slot (-1)
    int_mask: np.ndarray  # (S, m) bool
    # unary factor plumbing (empty second dim when there are no unaries):
    # each factor is owned by the submap containing its vertex; interior
    # targets go into that submap's A/g, separator targets into the global
    # separator system
    u_idx: np.ndarray  # (S, Umax) int32 — index into the packed unary arrays
    u_mask: np.ndarray  # (S, Umax) bool
    u_cls: np.ndarray  # (S, Umax) int8 — 0 interior, 1 separator, 2 drop
    u_loc: np.ndarray  # (S, Umax) int32 — interior slot (cls 0)
    u_gsep: np.ndarray  # (S, Umax) int32 — global separator slot (cls 1)


def partition_graph(
    edges_ij: np.ndarray,
    emask: np.ndarray,
    V: int,
    n_submaps: int,
    fixed: np.ndarray | None = None,
    unary_vid: np.ndarray | None = None,
) -> SubmapPartition:
    """Contiguous-range partition + separator classification (host side).

    ``fixed`` vertices are excluded from the variable set entirely (their
    increment is identically zero — the gauge row and column removed from
    the normal equations). ``unary_vid``: (K,) vertex id per packed unary
    factor; each factor is routed to the submap owning its vertex.
    """
    edges_ij = np.asarray(edges_ij)
    emask = np.asarray(emask, bool)
    fixed = np.zeros(V, bool) if fixed is None else np.asarray(fixed, bool).copy()
    S = int(n_submaps)
    bound = np.linspace(0, V, S + 1).astype(np.int64)
    v_sub = np.zeros(V, np.int64)
    for s in range(S):
        v_sub[bound[s]: bound[s + 1]] = s

    ii = edges_ij[emask, 0].astype(np.int64)
    jj = edges_ij[emask, 1].astype(np.int64)
    is_sep = np.zeros(V, bool)
    cross = v_sub[ii] != v_sub[jj]
    is_sep[ii[cross]] = True
    is_sep[jj[cross]] = True
    is_sep &= ~fixed
    v_cls = np.where(fixed, DROP, np.where(is_sep, SEP, INT)).astype(np.int8)

    # interior slots per submap
    m = 0
    int_slot = np.full(V, -1, np.int64)
    int_lists = []
    for s in range(S):
        vs = np.arange(bound[s], bound[s + 1])
        vs = vs[v_cls[vs] == INT]
        int_slot[vs] = np.arange(len(vs))
        int_lists.append(vs)
        m = max(m, len(vs))
    m = max(_pow2(m), 1)
    int_ids = np.full((S, m), -1, np.int64)
    for s, vs in enumerate(int_lists):
        int_ids[s, : len(vs)] = vs

    # global separator slots
    sep_vs = np.nonzero(v_cls == SEP)[0]
    n_sep = max(_pow2(len(sep_vs)), 1)
    sep_slot = np.full(V, -1, np.int64)
    sep_slot[sep_vs] = np.arange(len(sep_vs))
    sep_ids = np.full(n_sep, -1, np.int64)
    sep_ids[: len(sep_vs)] = sep_vs

    # edge ownership: the submap of an interior endpoint (edges between two
    # interiors are always same-submap by construction); otherwise submap of i
    own = np.where(
        v_cls[edges_ij[:, 0]] == INT,
        v_sub[edges_ij[:, 0]],
        np.where(v_cls[edges_ij[:, 1]] == INT, v_sub[edges_ij[:, 1]], v_sub[edges_ij[:, 0]]),
    )
    own = np.where(emask, own, -1)

    Emax = 1
    per_sub_edges = []
    for s in range(S):
        es = np.nonzero(own == s)[0]
        per_sub_edges.append(es)
        Emax = max(Emax, len(es))
    Emax = _pow2(Emax)
    e_idx = np.zeros((S, Emax), np.int64)
    e_mask = np.zeros((S, Emax), bool)
    for s, es in enumerate(per_sub_edges):
        e_idx[s, : len(es)] = es
        e_mask[s, : len(es)] = True

    # local separator lists per submap (separators its edges touch)
    k = 1
    sep_loc_maps = []
    for s, es in enumerate(per_sub_edges):
        vs = np.unique(edges_ij[es].ravel()) if len(es) else np.zeros(0, np.int64)
        vs = vs[v_cls[vs] == SEP]
        sep_loc_maps.append(vs)
        k = max(k, len(vs))
    k = _pow2(k)
    sep_l2g = np.zeros((S, k), np.int64)
    sep_l2g_mask = np.zeros((S, k), bool)
    v_seploc = np.full((S, V), -1, np.int64)  # per-submap local slot of vertex
    for s, vs in enumerate(sep_loc_maps):
        sep_l2g[s, : len(vs)] = sep_slot[vs]
        sep_l2g_mask[s, : len(vs)] = True
        v_seploc[s, vs] = np.arange(len(vs))

    # per-(submap, edge-slot, endpoint) class + local slot
    cls = np.full((S, Emax, 2), DROP, np.int8)
    loc = np.zeros((S, Emax, 2), np.int64)
    for s in range(S):
        es = e_idx[s]
        for side in (0, 1):
            v = edges_ij[es, side]
            c = np.where(e_mask[s], v_cls[v], DROP)
            cls[s, :, side] = c
            loc[s, :, side] = np.where(
                c == INT, int_slot[v], np.where(c == SEP, v_seploc[s, v], 0)
            )

    # unary factor routing
    if unary_vid is not None and len(unary_vid) > 0:
        uv = np.asarray(unary_vid, np.int64)
        u_own = v_sub[uv]
        Umax = 1
        per_sub_u = []
        for s in range(S):
            us = np.nonzero(u_own == s)[0]
            per_sub_u.append(us)
            Umax = max(Umax, len(us))
        Umax = _pow2(Umax)
        u_idx = np.zeros((S, Umax), np.int64)
        u_mask = np.zeros((S, Umax), bool)
        for s, us in enumerate(per_sub_u):
            u_idx[s, : len(us)] = us
            u_mask[s, : len(us)] = True
        uc = np.where(u_mask, v_cls[uv[u_idx]], DROP).astype(np.int8)
        u_loc = np.where(uc == INT, int_slot[uv[u_idx]], 0).astype(np.int64)
        u_gsep = np.where(uc == SEP, sep_slot[uv[u_idx]], 0).astype(np.int64)
    else:
        u_idx = np.zeros((S, 0), np.int64)
        u_mask = np.zeros((S, 0), bool)
        uc = np.zeros((S, 0), np.int8)
        u_loc = np.zeros((S, 0), np.int64)
        u_gsep = np.zeros((S, 0), np.int64)

    return SubmapPartition(
        n_submaps=S, m=m, k=k, n_sep=n_sep,
        e_idx=e_idx.astype(np.int32), e_mask=e_mask,
        cls=cls, loc=loc.astype(np.int32),
        sep_ids=sep_ids.astype(np.int32),
        sep_local2global=sep_l2g.astype(np.int32),
        sep_l2g_mask=sep_l2g_mask,
        int_ids=int_ids.astype(np.int32), int_mask=int_ids >= 0,
        u_idx=u_idx.astype(np.int32), u_mask=u_mask, u_cls=uc,
        u_loc=u_loc.astype(np.int32), u_gsep=u_gsep.astype(np.int32),
    )


# ---------------------------------------------------------------------------
# Device-side solve
# ---------------------------------------------------------------------------


def _cholesky(A):
    """Lower Cholesky factor with no host check: NaN where it failed."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _spd_solve(chol, b):
    """Solve A x = b given chol(A) for batched b (..., n, r)."""
    y = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)


def _scatter_sum(values, idx, size: int):
    """``segment_sum`` of the rows of ``values`` by ``idx`` into ``size``
    segments; rows aimed at ``size`` are dropped. Summed in float64 on a card
    (see the module's docstring), in the values' type on the CPU."""
    acc = torch.float64 if values.is_cuda else values.dtype
    out = values.new_zeros((size + 1,) + values.shape[1:], dtype=acc)
    out.index_add_(0, idx.reshape(-1), values.to(acc))
    return out[:size].to(values.dtype)


def _unary_residual(pose, z, sw, typ):
    """Unary prior residual (..., 3), type-dispatched (the same factors as
    ``optimize_pose_graph``'s prior_*/qprior_*/plane_* groups).

    ``z`` is packed pose-layout (..., 7): [:4] quaternion measurement
    (identity for non-quat factors), [4:] xyz measurement / plane height in
    z[6]. typ: 0 = absolute position, 1 = absolute orientation, 2 = plane.
    """
    r_xyz = pose[..., 4:] - z[..., 4:]
    q = se3.pose_quat(pose)
    r_quat = se3.so3_log(se3.quat_mul(se3.quat_conj(z[..., :4]), q))
    ez = torch.zeros_like(r_xyz)
    ez[..., 2] = 1.0
    a = se3.quat_rotate(q, ez)
    r_plane = torch.stack([pose[..., 6] - z[..., 6], a[..., 0], a[..., 1]], dim=-1)
    t = typ[..., None]
    r = torch.where(t == 0, r_xyz, torch.where(t == 1, r_quat, r_plane))
    return r * sw


def _unary_boxplus(x, pose, z, sw, typ):
    return _unary_residual(se3.pose_retract(pose, x), z, sw, typ)


def _unary_res_jac(pose, z, sw, typ):
    """Residual (K,3) and Jacobian (K,3,6) of a flat batch of unaries."""
    x0 = pose.new_zeros(pose.shape[:-1] + (6,))
    r = _unary_boxplus(x0, pose, z, sw, typ)
    J = torch.func.vmap(torch.func.jacfwd(_unary_boxplus))(x0, pose, z, sw, typ)
    return r, J


class _Plumbing(NamedTuple):
    """The partition's index arrays on the solve's device."""

    e_idx: torch.Tensor
    e_mask: torch.Tensor
    cls: torch.Tensor
    loc: torch.Tensor
    sep_ids: torch.Tensor
    l2g: torch.Tensor
    l2g_mask: torch.Tensor
    int_ids: torch.Tensor
    int_mask: torch.Tensor
    u_idx: torch.Tensor
    u_mask: torch.Tensor
    u_cls: torch.Tensor
    u_loc: torch.Tensor
    u_gsep: torch.Tensor


def _plumbing(part: SubmapPartition, device, rows=slice(None)) -> _Plumbing:
    """The index arrays of the submaps ``rows`` (all by default) on ``device``;
    ``sep_ids`` is global and whole."""
    def t(a, sub=True):
        a = np.asarray(a)[rows] if sub else np.asarray(a)
        return torch.as_tensor(a if a.dtype == bool else a.astype(np.int64), device=device)

    return _Plumbing(
        t(part.e_idx), t(part.e_mask), t(part.cls), t(part.loc), t(part.sep_ids, sub=False),
        t(part.sep_local2global), t(part.sep_l2g_mask), t(part.int_ids), t(part.int_mask),
        t(part.u_idx), t(part.u_mask), t(part.u_cls), t(part.u_loc), t(part.u_gsep),
    )


def _mesh_sum(x, mesh: Mesh | None):
    """Σ of ``x`` over the mesh, added in float64 on a card and rounded once
    (``x`` itself without a mesh)."""
    if mesh is None:
        return x
    acc = torch.float64 if x.is_cuda else x.dtype
    return allreduce(x.to(acc), mesh).to(x.dtype)


def _schur_gn_step(part: SubmapPartition, params: PoseGraphParams, pl: _Plumbing,
                   poses, t: int, edges, unaries, mesh: Mesh | None = None):
    """One GN step of the Schur solve → (new poses, dx norm). ``pl`` holds
    this rank's submaps (all of them without a mesh)."""
    S, m, k, n_sep = pl.e_idx.shape[0], part.m, part.k, part.n_sep
    m6, k6, n6 = 6 * m, 6 * k, 6 * n_sep
    e_ij, e_z, e_sw, e_rob = edges
    dev, dt = poses.device, poses.dtype
    E = pl.e_idx.shape[1]

    # gather the edges: (S, Emax, ...)
    eij = e_ij[pl.e_idx]
    sqrtw = e_sw[pl.e_idx] * pl.e_mask[..., None]
    erob = e_rob[pl.e_idx]
    r, Ji, Jj = _edge_res_jac(
        poses[eij[..., 0].reshape(-1)], poses[eij[..., 1].reshape(-1)],
        e_z[pl.e_idx].reshape(-1, 7),
    )
    r = r.reshape(S, E, 6) * sqrtw
    Ji = Ji.reshape(S, E, 6, 6) * sqrtw[..., None]
    Jj = Jj.reshape(S, E, 6, 6) * sqrtw[..., None]
    # per-edge kernel policy + GNC schedule, as in `optimize_pose_graph`
    # (robust weight only on loop edges; the median floor over all edges)
    r2 = torch.sum(r * r, -1)
    w = _edge_weights(
        r2.reshape(-1), erob.reshape(-1), pl.e_mask.reshape(-1), params, t
    ).reshape(r2.shape) * pl.e_mask

    J = torch.stack([Ji, Jj], dim=2)  # (S, E, 2, 6, 6)
    wr = r * w[..., None]
    # all four ordered endpoint pairs (p, q): C_pq = Jpᵀ W Jq
    C = torch.einsum("sepab,se,seqac->sepqbc", J, w, J)  # (S,E,2,2,6,6)
    g_blk = torch.einsum("sepab,sea->sepb", J, wr)  # (S,E,2,6)

    cls, loc = pl.cls, pl.loc
    cp, cq = cls[:, :, :, None], cls[:, :, None, :]
    lp, lq = loc[:, :, :, None], loc[:, :, None, :]
    sub = torch.arange(S, device=dev)[:, None, None, None]

    def scat(dest_idx, mask, blocks, size):
        idx = torch.where(mask, dest_idx, size)
        vals = (blocks * mask[..., None, None]).reshape(-1, 6, 6)
        return _scatter_sum(vals, idx, size)

    def scat_g(dest_idx, mask, blocks, size):
        idx = torch.where(mask, dest_idx, size)
        return _scatter_sum((blocks * mask[..., None]).reshape(-1, 6), idx, size)

    # A: interior×interior, per submap
    mA = (cp == INT) & (cq == INT)
    A = scat((sub * m + lp) * m + lq, mA, C, S * m * m).reshape(S, m, m, 6, 6)
    # B: interior×separator(local)
    mB = (cp == INT) & (cq == SEP)
    B = scat((sub * m + lp) * k + lq, mB, C, S * m * k).reshape(S, m, k, 6, 6)
    # separator×separator → GLOBAL sep matrix (local slots → global); an
    # interior endpoint's slot may lie past k, and its entry is masked
    loc_sep = torch.where(cls == SEP, loc, 0)
    gp = torch.gather(pl.l2g, 1, loc_sep.reshape(S, -1)).reshape(loc.shape)
    mS = (cp == SEP) & (cq == SEP)
    Hs = scat(gp[:, :, :, None] * n_sep + gp[:, :, None, :], mS, C,
              n_sep * n_sep).reshape(n_sep, n_sep, 6, 6)

    # gradients
    mgi = cls == INT
    g_int = scat_g(torch.arange(S, device=dev)[:, None, None] * m + loc, mgi, g_blk,
                   S * m).reshape(S, m, 6)
    g_sep = scat_g(gp, cls == SEP, g_blk, n_sep)  # (n_sep, 6)

    # unary priors: diagonal 6×6 block + gradient on the factor's vertex —
    # interior targets into A/g, separator targets into the separator system
    if pl.u_idx.shape[1] > 0:
        u_vid, u_z, u_sw, u_typ = unaries
        U = pl.u_idx.shape[1]
        ui = pl.u_idx.reshape(-1)
        r_u, J_u = _unary_res_jac(poses[u_vid[ui]], u_z[ui], u_sw[ui], u_typ[ui])
        r_u, J_u = r_u.reshape(S, U, 3), J_u.reshape(S, U, 3, 6)
        C_u = torch.einsum("suab,suac->subc", J_u, J_u)  # (S,U,6,6)
        g_u = torch.einsum("suab,sua->sub", J_u, r_u)  # (S,U,6)
        sub_u = torch.arange(S, device=dev)[:, None]
        mUi = pl.u_mask & (pl.u_cls == INT)
        A = A + scat((sub_u * m + pl.u_loc) * m + pl.u_loc, mUi, C_u,
                     S * m * m).reshape(S, m, m, 6, 6)
        g_int = g_int + scat_g(sub_u * m + pl.u_loc, mUi, g_u, S * m).reshape(S, m, 6)
        mUs = pl.u_mask & (pl.u_cls == SEP)
        Hs = Hs + scat(pl.u_gsep * n_sep + pl.u_gsep, mUs, C_u,
                       n_sep * n_sep).reshape(n_sep, n_sep, 6, 6)
        g_sep = g_sep + scat_g(pl.u_gsep, mUs, g_u, n_sep)

    # dense per-submap interior system (S, 6m, 6m); padded interior slots
    # carry an identity diagonal so the factorization stays SPD
    Ad = A.permute(0, 1, 3, 2, 4).reshape(S, m6, m6)
    dmask = torch.repeat_interleave(~pl.int_mask, 6, dim=1).to(dt)  # (S, 6m)
    Ad = Ad + torch.diag_embed(dmask) + torch.eye(m6, dtype=dt, device=dev) * params.damping
    chol = _cholesky(Ad)

    Bd = B.permute(0, 1, 3, 2, 4).reshape(S, m6, k6)
    gi = g_int.reshape(S, m6)

    Y = _spd_solve(chol, Bd)  # (S, 6m, 6k)
    xg = _spd_solve(chol, gi[..., None])[..., 0]  # (S, 6m)

    dH = torch.einsum("smk,sml->skl", Bd, Y)  # (S, 6k, 6k)
    dg = torch.einsum("smk,sm->sk", Bd, xg)  # (S, 6k)

    # scatter local (6k) blocks into the global separator system
    l2g_safe = torch.where(pl.l2g_mask, pl.l2g, n_sep)
    rowg = (l2g_safe[:, :, None] * 6 + torch.arange(6, device=dev)).reshape(S, k6)
    flat = rowg[:, :, None] * (n6 + 6) + rowg[:, None, :]
    Hs_corr = _scatter_sum(dH.reshape(-1), flat, (n6 + 6) * (n6 + 6)).reshape(
        n6 + 6, n6 + 6)[:n6, :n6]
    gs_corr = _scatter_sum(dg.reshape(-1), rowg, n6 + 6)[:n6]

    Hsep = _mesh_sum(Hs.permute(0, 2, 1, 3).reshape(n6, n6) - Hs_corr, mesh)
    gsep = _mesh_sum(g_sep.reshape(n6) - gs_corr, mesh)

    # sep_ids is data of this call's partition, never a constant of the code
    sep_pad = torch.repeat_interleave(pl.sep_ids < 0, 6).to(dt)
    Hsep = Hsep + torch.diag(sep_pad) + torch.eye(n6, dtype=dt, device=dev) * params.damping
    chol_s = _cholesky(Hsep)
    dx_sep = _spd_solve(chol_s, (-gsep)[:, None])[:, 0]  # (6·n_sep,)

    # back-substitution: dx_int = A⁻¹(−g_i − B dx_sep_local)
    dxs_local = dx_sep.reshape(n_sep, 6)[l2g_safe.clamp(0, n_sep - 1)]
    dxs_local = dxs_local * pl.l2g_mask[..., None]
    rhs = -gi - torch.einsum("smk,sk->sm", Bd, dxs_local.reshape(S, k6))
    dx_int = _spd_solve(chol, rhs[..., None])[..., 0]  # (S, 6m)

    # scatter into (V, 6): interiors + separators
    V = poses.shape[0]
    ids = torch.where(pl.int_mask, pl.int_ids, V)
    dxv = _mesh_sum(_scatter_sum(
        (dx_int.reshape(S, m, 6) * pl.int_mask[..., None]).reshape(-1, 6), ids, V), mesh)
    # dx_sep is replicated (every rank solved the same summed system), so it
    # is added here and not summed over the mesh
    sep_ids_safe = torch.where(pl.sep_ids >= 0, pl.sep_ids, V)
    dxv = dxv + _scatter_sum(
        dx_sep.reshape(n_sep, 6) * (pl.sep_ids >= 0)[:, None], sep_ids_safe, V)

    dxv = _clamp_step(dxv, params)
    new_poses = se3.pose_retract(poses, dxv)
    dxn = torch.sqrt(torch.sum(dxv * dxv) / V)
    return new_poses, dxn


def _host(x, dtype=None):
    """A host numpy copy of an array or tensor (None stays None)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _pack_unaries(
    prior_xyz, prior_idx, prior_sqrtw, prior_mask,
    qprior_quat, qprior_idx, qprior_sqrtw, qprior_mask,
    plane_idx, plane_z, plane_sqrtw, plane_mask,
):
    """Pack the three prior groups into one typed list (host side).

    Packed measurement layout is pose-shaped (7,): [:4] quaternion (identity
    unless an orientation prior), [4:] xyz (plane height in slot 6).
    """
    vids, zs, sws, typs = [], [], [], []

    def take(idx, mask):
        idx = _host(idx, np.int64)
        m = np.ones(idx.shape, bool) if mask is None else _host(mask, bool)
        return idx[m], m

    if prior_idx is not None:
        idx, m = take(prior_idx, prior_mask)
        z = np.zeros((idx.size, 7), np.float32)
        z[:, 0] = 1.0
        z[:, 4:] = _host(prior_xyz, np.float32)[m]
        vids.append(idx)
        zs.append(z)
        sws.append(_host(prior_sqrtw, np.float32)[m])
        typs.append(np.zeros(idx.size, np.int32))
    if qprior_idx is not None:
        idx, m = take(qprior_idx, qprior_mask)
        z = np.zeros((idx.size, 7), np.float32)
        z[:, :4] = _host(qprior_quat, np.float32)[m]
        vids.append(idx)
        zs.append(z)
        sws.append(_host(qprior_sqrtw, np.float32)[m])
        typs.append(np.ones(idx.size, np.int32))
    if plane_idx is not None:
        idx, m = take(plane_idx, plane_mask)
        z = np.zeros((idx.size, 7), np.float32)
        z[:, 0] = 1.0
        z[:, 6] = _host(plane_z, np.float32)[m]
        vids.append(idx)
        zs.append(z)
        sws.append(_host(plane_sqrtw, np.float32)[m])
        typs.append(np.full(idx.size, 2, np.int32))

    if not vids:
        return (np.zeros(0, np.int64), np.zeros((0, 7), np.float32),
                np.zeros((0, 3), np.float32), np.zeros(0, np.int32))
    return (np.concatenate(vids), np.concatenate(zs),
            np.concatenate(sws), np.concatenate(typs))


def optimize_pose_graph_schur(
    poses,
    edges_ij,
    edges_z,
    edges_sqrtw,
    emask,
    n_submaps: int = 16,
    fixed=None,
    mesh: Mesh | None = None,
    edges_robust=None,
    prior_xyz=None, prior_idx=None, prior_sqrtw=None, prior_mask=None,
    qprior_quat=None, qprior_idx=None, qprior_sqrtw=None, qprior_mask=None,
    plane_idx=None, plane_z=None, plane_sqrtw=None, plane_mask=None,
    params: PoseGraphParams = PoseGraphParams(),
):
    """Schur-complement submap solve on the device of ``poses`` (a tensor),
    or with ``mesh`` on the mesh's device, each rank eliminating its share of
    the submaps (``n_submaps`` rounded up to a multiple of the mesh size).

    Interface of ``optimize_pose_graph`` without ``vmask`` (every vertex is
    real: pad the graph before calling and fix the padding). The edge arrays
    may be tensors or numpy; the graph's topology (``edges_ij``, ``emask``,
    ``fixed``, the unaries' ids and masks) is read on the host to partition
    it. Returns (poses, PoseGraphStats), replicated over the mesh.
    """
    V = poses.shape[0]
    if mesh is not None:
        poses = poses.to(mesh.device)
    dev = poses.device
    if fixed is None:
        fixed_np = np.zeros(V, bool)
        fixed_np[0] = True
    else:
        fixed_np = _host(fixed, bool)

    u_vid, u_z, u_sw, u_typ = _pack_unaries(
        prior_xyz, prior_idx, prior_sqrtw, prior_mask,
        qprior_quat, qprior_idx, qprior_sqrtw, qprior_mask,
        plane_idx, plane_z, plane_sqrtw, plane_mask,
    )
    n_dev = 1 if mesh is None else mesh.size
    S = -(-max(n_submaps, n_dev) // n_dev) * n_dev  # a multiple of the mesh size
    part = partition_graph(_host(edges_ij), _host(emask, bool), V, S, fixed_np,
                           unary_vid=u_vid)
    S_l = S // n_dev
    rank = 0 if mesh is None else mesh.rank
    pl = _plumbing(part, dev, slice(rank * S_l, (rank + 1) * S_l))

    def on_dev(a, dtype):
        return torch.as_tensor(a, device=dev).to(dtype)

    e_ij = on_dev(edges_ij, torch.int64)
    e_z = on_dev(edges_z, poses.dtype)
    e_sw = on_dev(edges_sqrtw, poses.dtype) * on_dev(emask, torch.bool)[:, None]
    e_rob = (torch.ones(e_ij.shape[0], dtype=torch.bool, device=dev)
             if edges_robust is None else on_dev(edges_robust, torch.bool))
    edges = (e_ij, e_z, e_sw, e_rob)
    unaries = (on_dev(u_vid, torch.int64), on_dev(u_z, poses.dtype),
               on_dev(u_sw, poses.dtype), on_dev(u_typ, torch.int64))

    def chi2_of(p):
        r = edge_residual(p[e_ij[:, 0]], p[e_ij[:, 1]], e_z) * e_sw
        c = torch.sum(r * r)
        if u_vid.size:
            u_vid_d, u_z_d, u_sw_d, u_typ_d = unaries
            ru = _unary_residual(p[u_vid_d], u_z_d, u_sw_d, u_typ_d)
            c = c + torch.sum(ru * ru)
        return c

    chi2_0 = chi2_of(poses)
    p = poses
    iters = 0
    while iters < params.gn_iters:
        p, dxn = _schur_gn_step(part, params, pl, p, iters, edges, unaries, mesh)
        # no convergence mid-GNC-anneal (the surrogate is still changing)
        small = (dxn < params.converged_dx) & (iters >= params.gnc_iters)
        iters += 1
        if bool(small):  # replicated bit for bit: every rank stops together
            break
    return p, PoseGraphStats(
        chi2_initial=chi2_0,
        chi2_final=chi2_of(p),
        iterations=torch.tensor(iters, dtype=torch.int32, device=dev),
    )
