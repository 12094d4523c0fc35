"""Scan-to-map registration as a Gauss-Newton loop on torch tensors.

Counterpart of ``lmsf_slam_tpu/ops/registration.py`` (``register_edge_surf``,
``register_point_to_plane``, ``register_and_score``, ``evaluate_alignment``
and their helpers): 5-NN PCA line / plane fits, point-to-line and
point-to-plane residuals, huber weights, optional trimmed GN, the degeneracy
projector of JᵀJ and the κ-penalised 6×6 Cholesky step; and the alignment
evaluator (score and overlap of a scan against a map) that gates loop
closures, relocalization and localization.

The reference runs the loop as one ``lax.scan`` with ``lax.cond`` around the
association and the projector. Here the loop is a Python loop over a static
number of iterations, and both conditionals become a select: on an
association iteration the new correspondences and projector are computed and
``torch.where(do_assoc, new, old)`` keeps the old ones once the solve is done.
So ``num_matches`` and ``final_cost`` are those of the LAST iteration, as in
the reference, and the loop never reads a value back to the host. Association
is the k-NN kernel (:mod:`.knn`), which also writes the neighbours'
coordinates on the card: two searches per association, five associations per
call at the default cadence; the 6×6 eigen-analysis of the projector is the
projector kernel (:mod:`.projector`), once an association.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..common import se3
from ..common.pointcloud import PointBatch
from . import mat3, neighbors, projector


class RegistrationParams(NamedTuple):
    max_iters: int = 10
    k_neighbors: int = 5
    max_corr_dist: float = 1.0  # association gate (m)
    edge_eig_ratio: float = 3.0  # line validity: λ_max > ratio·λ_mid
    plane_tol: float = 0.2  # plane validity: all fit pts within (m)
    huber_delta: float = 0.5  # robust loss scale (m)
    # adaptive trimming: zero weight beyond trim_rel × median |r| from
    # iteration trim_after on (0 disables); trim_floor bounds the cut
    trim_rel: float = 0.0
    trim_floor: float = 0.5
    trim_after: int = 4
    degen_thresh: float = 100.0  # absolute eigenvalue floor of JᵀJ
    # match-count-normalised floor degen_rel · n_matches (the default; 0
    # falls back to the absolute degen_thresh)
    degen_rel: float = 0.01
    damping: float = 1e-4  # LM-style diagonal damping
    trans_converged: float = 5e-4  # m
    rot_converged: float = 1e-3  # rad
    # correspondences are rebuilt every this many GN iterations
    reassociate_every: int = 2


class RegistrationResult(NamedTuple):
    pose: torch.Tensor  # (7,)
    converged: torch.Tensor  # bool
    iterations: torch.Tensor  # int32 — iterations until convergence
    num_matches: torch.Tensor  # int32 — valid correspondences at final iter
    final_cost: torch.Tensor  # mean robust cost
    n_constrained: torch.Tensor  # int32 — directions above the degeneracy floor


# ---------------------------------------------------------------------------
# Correspondence builders → per-point (normal, offset, valid)
# residual model: r_i = n_i · p_world_i + d_i
# ---------------------------------------------------------------------------


def _fit_neighbors(p_world, q_mask, map_pb: PointBatch, params):
    """k-NN of each query in the map: (dists, query and neighbour xyz in
    float64, validity).

    The line and plane fits run in float64 and return float32. Their 3×3
    covariances are often near-degenerate (5 neighbours along one scan ring:
    the two small eigenvalues within ~1e-4 of the largest), where a float32
    eigenvector moves by up to 0.04 under a change of summation order alone;
    measured on sim frames, that moves the tracked pose by ~1e-3 m between
    two float32 runs that differ only in that order (CPU vs card). In float64
    the same cases move by ~1e-12.
    """
    dists, _, nbr = neighbors.knn_with_neighbors(
        p_world, q_mask, map_pb.xyz, map_pb.mask, k=params.k_neighbors
    )
    nvalid = dists < neighbors.INF
    return dists, p_world.to(torch.float64), nbr.to(torch.float64), nvalid


def _edge_correspondences(p_world, q_mask, map_pb: PointBatch, params):
    """Point-to-line: 5-NN PCA; returns unit normal toward the line and
    offset so that r = n·p + d is the point-line distance."""
    dists, p_world, nbr, nvalid = _fit_neighbors(p_world, q_mask, map_pb, params)
    k = params.k_neighbors
    n_nbr = torch.sum(nvalid, dim=1, dtype=torch.int32)
    wsum = torch.clamp(n_nbr, min=1)[:, None]
    centroid = torch.sum(torch.where(nvalid[..., None], nbr, 0.0), dim=1) / wsum
    diff = torch.where(nvalid[..., None], nbr - centroid[:, None, :], 0.0)
    cov = torch.einsum("nki,nkj->nij", diff, diff) / wsum[..., None]
    eigval, eigvec = mat3.sym_eigh3(cov)  # ascending, analytic
    direction = eigvec[..., 2]  # largest
    line_ok = eigval[:, 2] > params.edge_eig_ratio * torch.clamp(eigval[:, 1], min=1e-9)
    # perpendicular residual direction
    pc = p_world - centroid
    along = torch.sum(pc * direction, dim=-1, keepdim=True)
    perp = pc - along * direction
    dist_line = torch.linalg.vector_norm(perp, dim=-1)
    n = perp / torch.clamp(dist_line[:, None], min=1e-9)
    d = -torch.sum(n * (p_world - perp), dim=-1)  # foot point on the line
    valid = (
        q_mask
        & line_ok
        & (n_nbr >= k)
        & (dists[:, k - 1] < params.max_corr_dist**2)
    )
    # zero invalid lanes so padded/degenerate fits cannot poison reductions
    n = torch.where(valid[:, None], torch.nan_to_num(n), 0.0)
    d = torch.where(valid, torch.nan_to_num(d), 0.0)
    return n.to(torch.float32), d.to(torch.float32), valid


def _surf_correspondences(p_world, q_mask, map_pb: PointBatch, params):
    """Point-to-plane via PCA plane fit of the 5-NN (centroid + smallest
    eigenvector normal)."""
    dists, p_world, nbr, nvalid = _fit_neighbors(p_world, q_mask, map_pb, params)
    k = params.k_neighbors
    w = nvalid.to(torch.float64)
    wsum = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1.0)
    centroid = torch.sum(nbr * w[..., None], dim=1) / wsum
    diff = (nbr - centroid[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", diff, diff) / wsum[..., None]
    eigval, eigvec = mat3.sym_eigh3(cov)
    n = eigvec[..., 0]  # smallest eigenvalue direction = plane normal
    d = -torch.sum(n * centroid, dim=-1)
    # planarity: every neighbor within plane_tol of the plane
    pd = torch.abs(torch.einsum("nki,ni->nk", nbr, n) + d[:, None])
    plane_ok = torch.all(torch.where(nvalid, pd < params.plane_tol, True), dim=1)
    valid = (
        q_mask
        & plane_ok
        & (torch.sum(nvalid, dim=1) >= k)
        & (dists[:, k - 1] < params.max_corr_dist**2)
    )
    n = torch.where(valid[:, None], torch.nan_to_num(n), 0.0)
    d = torch.where(valid, torch.nan_to_num(d), 0.0)
    return n.to(torch.float32), d.to(torch.float32), valid


def _gn_normal_equations(p_src, n, r, w, R):
    """Accumulate H (6,6), g (6,) for residuals r = n·(R p + t) + d under the
    right perturbation T·exp(ξ): the row is J = [p × Rᵀn, Rᵀn]."""
    nR = n @ R  # (Rᵀn)ᵀ per point
    Jrot = torch.linalg.cross(p_src, nR, dim=-1)
    J = torch.cat([Jrot, nR], dim=-1)  # (N,6)
    H = (J * w[:, None]).T @ J
    g = J.T @ (r * w)
    return H, g


def _huber_w(r, delta):
    a = torch.abs(r)
    return torch.where(a <= delta, 1.0, delta / torch.clamp(a, min=1e-12))


def _degeneracy_projector(H, params, nmatch=None):
    """Eigen-analysis of JᵀJ → (projector onto the well-constrained
    directions, count of constrained directions). Floor: ``degen_rel·nmatch``
    when configured, else the absolute ``degen_thresh``
    (:mod:`.projector`: the kernel on the card, ``torch.linalg.eigh`` on the
    CPU).

    The projector is computed and returned in float64. The solve adds
    κ(I − P) with κ = 1e7, so a float32 P, whose entries carry ~5e-7 of
    rounding, puts O(1) noise on H — measured on a sim frame, enough to move
    the GN step by 3% along a direction with eigenvalue 17.5 — and makes the
    step differ between devices and LAPACK builds. In float64 that noise is
    ~1e-9. (The reference's own float32 projector carries the noise, which
    bounds how closely any other implementation can follow it.)

    A non-finite H (a solve that broke down) gives a NaN projector and 0
    constrained directions, as the reference's ``eigh`` does.
    """
    rel = params.degen_rel > 0.0 and nmatch is not None
    return projector.degeneracy_projector(H, nmatch if rel else None, params.damping,
                                          params.degen_rel, params.degen_thresh)


def _nan_to_num_pb(pb: PointBatch) -> PointBatch:
    return PointBatch(torch.nan_to_num(pb.xyz), pb.mask, pb.attr)


def register_edge_surf(
    src_edge: PointBatch,
    src_surf: PointBatch,
    map_edge: PointBatch,
    map_surf: PointBatch,
    init_pose: torch.Tensor,
    params: RegistrationParams = RegistrationParams(),
) -> RegistrationResult:
    """Edge+surf feature Gauss-Newton registration (scan-to-map).

    Either feature set may be empty (all-False mask) — with empty edges this
    is exactly sparse point-to-plane ICP.
    """
    # real lidar scans contain NaN returns; sanitize so masked-out lanes
    # cannot poison reductions through 0·NaN
    src_edge = _nan_to_num_pb(src_edge)
    src_surf = _nan_to_num_pb(src_surf)
    dev = init_pose.device
    eye = torch.eye(6, dtype=torch.float32, device=dev)

    pose = init_pose.to(torch.float32)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    n_con = torch.zeros((), dtype=torch.int32, device=dev)
    P = eye.to(torch.float64)  # the projector is float64 (_degeneracy_projector)
    corr = (
        torch.zeros_like(src_edge.xyz), torch.zeros_like(src_edge.xyz[:, 0]),
        torch.zeros_like(src_edge.mask),
        torch.zeros_like(src_surf.xyz), torch.zeros_like(src_surf.xyz[:, 0]),
        torch.zeros_like(src_surf.mask),
    )
    nmatch = cost = None
    for i in range(params.max_iters):
        pe_w = se3.pose_apply(pose, src_edge.xyz)
        ps_w = se3.pose_apply(pose, src_surf.xyz)

        assoc_iter = (i % params.reassociate_every) == 0
        if assoc_iter:
            # lax.cond(do_assoc, associate, keep) as compute-then-select
            do_assoc = ~done
            new = (
                *_edge_correspondences(pe_w, src_edge.mask, map_edge, params),
                *_surf_correspondences(ps_w, src_surf.mask, map_surf, params),
            )
            corr = tuple(torch.where(do_assoc, a, b) for a, b in zip(new, corr))
        ne, de, ve, ns, ds, vs = corr

        R = se3.quat_to_matrix(se3.pose_quat(pose))
        re = torch.sum(ne * pe_w, dim=-1) + de
        rs = torch.sum(ns * ps_w, dim=-1) + ds
        we = _huber_w(re, params.huber_delta) * ve
        ws = _huber_w(rs, params.huber_delta) * vs
        if params.trim_rel > 0.0 and i >= params.trim_after:
            # adaptive trimmed GN: residuals beyond trim_rel × median(|r|)
            # get zero weight (the cut is +inf before trim_after)
            av = torch.cat([
                torch.where(ve, torch.abs(re), torch.inf),
                torch.where(vs, torch.abs(rs), torch.inf),
            ])
            n_v = torch.sum(ve, dtype=torch.int32) + torch.sum(vs, dtype=torch.int32)
            mid = (torch.clamp(n_v - 1, min=0) // 2).reshape(1).long()
            med = torch.sort(av).values.index_select(0, mid)[0]
            med = torch.where(n_v > 0, med, 0.0)
            cut = torch.clamp(params.trim_rel * med, min=params.trim_floor)
            we = we * (torch.abs(re) <= cut)
            ws = ws * (torch.abs(rs) <= cut)

        He, ge = _gn_normal_equations(src_edge.xyz, ne, re, we, R)
        Hs, gs = _gn_normal_equations(src_surf.xyz, ns, rs, ws, R)
        H, g = He + Hs, ge + gs

        # degeneracy projector refreshed at association iterations only
        nmatch = torch.sum(ve, dtype=torch.int32) + torch.sum(vs, dtype=torch.int32)
        if assoc_iter:
            P_new, n_con_new = _degeneracy_projector(H, params, nmatch)
            P = torch.where(do_assoc, P_new, P)
            n_con = torch.where(do_assoc, n_con_new, n_con)
        # Cholesky solve with the degenerate subspace penalised out:
        # (H + λI + κ(I−P)) x = −g, then the explicit projection
        kappa = 1e7
        penalty = (kappa * (torch.eye(6, dtype=P.dtype, device=dev) - P)).to(torch.float32)
        Hs_ = H + params.damping * eye + penalty
        xi = P.to(torch.float32) @ mat3.chol_solve6(Hs_, -g)
        new_pose = se3.pose_retract(pose, xi)

        small = (torch.linalg.vector_norm(xi[:3]) < params.rot_converged) & (
            torch.linalg.vector_norm(xi[3:]) < params.trans_converged
        )
        pose = torch.where(done, pose, new_pose)
        cost = (torch.sum(we * re * re) + torch.sum(ws * rs * rs)) / torch.clamp(
            nmatch, min=1
        )
        iters = iters + (~done).to(torch.int32)
        done = done | small
    return RegistrationResult(
        pose=pose,
        converged=done,
        iterations=iters,
        num_matches=nmatch,
        final_cost=cost,
        n_constrained=n_con,
    )


def register_point_to_plane(
    src: PointBatch, map_pb: PointBatch, init_pose, params=RegistrationParams()
) -> RegistrationResult:
    """sparse_point_plane_icp: surf-only registration against a raw map."""
    empty = PointBatch.empty(8, device=src.xyz.device)
    return register_edge_surf(empty, src, empty, map_pb, init_pose, params)


def register_and_score(
    src_edge: PointBatch,
    src_surf: PointBatch,
    map_edge: PointBatch,
    map_surf: PointBatch,
    init_pose: torch.Tensor,
    params: RegistrationParams = RegistrationParams(),
    min_overlap=0.2,
):
    """Registration followed by alignment evaluation of its pose — the
    localization cycle. Returns (RegistrationResult, score, overlap) as
    tensors; the caller reads them back together."""
    reg = register_edge_surf(src_edge, src_surf, map_edge, map_surf, init_pose, params)
    score, overlap = evaluate_alignment(src_surf, map_surf, reg.pose, min_overlap=min_overlap)
    return reg, score, overlap


# ---------------------------------------------------------------------------
# Alignment evaluation
# ---------------------------------------------------------------------------


def evaluate_alignment(
    src: PointBatch,
    map_pb: PointBatch,
    pose: torch.Tensor,
    inlier_dist: float = 1.0,
    min_overlap=0.2,
    score_dist: float = 0.5,
):
    """Score = mean squared surface distance over inliers; overlap = 1-NN
    inlier ratio.

    Score and overlap answer different questions and use different radii:
    ``overlap`` measures COVERAGE (fraction of the scan within
    ``inlier_dist`` of the map), while ``score`` measures ALIGNMENT of the
    covered region, over the tighter ``score_dist`` ring; when that ring is
    (nearly) empty — gross misalignment — the score falls back to the full
    coverage ring. The scored distance is point-to-PLANE where the 5-NN
    within ``inlier_dist`` are planar (at least 3 of them, all within 0.2 m
    of their fitted plane), else the 1-NN point distance, so the gates
    measure alignment and not the spacing of the stored features.

    One k-NN search (k = 5) that also returns the neighbours' coordinates,
    so no gather follows the kernel. The plane fit runs in float64, like the
    surf fits of the registration (five neighbours along one scan ring give a
    near-degenerate covariance whose float32 eigenvector is set by rounding
    order); distances, counts and the score are float32.

    Returns (score, overlap) as 0-dim tensors; score is 1e9 when overlap <
    ``min_overlap``.
    """
    p_w = se3.pose_apply(pose.to(torch.float32), src.xyz)
    d, _, nbr = neighbors.knn_with_neighbors(p_w, src.mask, map_pb.xyz, map_pb.mask, k=5)
    d1 = d[:, 0]  # squared 1-NN point distance
    # plane support is bounded to the correspondence radius: a neighbor
    # farther than inlier_dist must not lend its plane to the query; with <3
    # in-radius neighbors the score falls back to the point distance
    nvalid = d < inlier_dist * inlier_dist
    nbr = nbr.to(torch.float64)
    w = nvalid.to(torch.float64)
    n_support = torch.sum(w, dim=1)
    wsum = torch.clamp(n_support, min=1.0)[:, None]
    centroid = torch.sum(nbr * w[..., None], dim=1) / wsum
    diff = (nbr - centroid[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", diff, diff) / wsum[..., None]
    n = mat3.sym_eigh3(cov)[1][..., 0]  # smallest-eigval dir = plane normal
    # planar neighborhood: enough support and thin out-of-plane extent
    pd = torch.abs(
        torch.sum(nbr * n[:, None, :], dim=-1) - torch.sum(n * centroid, dim=-1)[:, None]
    )
    plane_ok = (n_support >= 3.0) & torch.all(torch.where(nvalid, pd < 0.2, True), dim=1)
    d_plane = torch.square(torch.sum((p_w.to(torch.float64) - centroid) * n, dim=-1))
    d_surf = torch.where(plane_ok, d_plane.to(torch.float32), d1)

    inlier = src.mask & (d1 < inlier_dist * inlier_dist)
    n_src = torch.clamp(torch.sum(src.mask), min=1)
    n_in = torch.sum(inlier)
    overlap = (n_in / n_src).to(torch.float32)
    # alignment score over the tight ring; coverage-ring fallback when the
    # tight ring is (nearly) empty — i.e. gross misalignment
    s_in = src.mask & (d1 < score_dist * score_dist)
    n_s = torch.sum(s_in)
    score_tight = torch.sum(torch.where(s_in, d_surf, 0.0)) / torch.clamp(n_s, min=1)
    score_cover = torch.sum(torch.where(inlier, d_surf, 0.0)) / torch.clamp(n_in, min=1)
    score = torch.where(n_s > 0.05 * n_in, score_tight, score_cover)
    score = torch.where(overlap < min_overlap, 1e9, score)
    return score, overlap
