"""Edge + surf scan-to-map registration, plain PyTorch in float64.

The system's Gauss-Newton: exact k-NN (brute force here), 5-NN PCA line and
plane fits, point-to-line / point-to-plane residuals, huber weights,
optional trimming, the degeneracy projector of JᵀJ (``torch.linalg.eigh``)
and the κ-penalised 6×6 solve, re-associating every ``reassociate_every``
iterations and stopping once a step is small. Everything runs in the dtype of
the inputs; the reference passes float64.
"""
from __future__ import annotations

import torch

from . import se3

REGISTRATION_DEFAULTS = dict(max_iters=10, k_neighbors=5, max_corr_dist=1.0, edge_eig_ratio=3.0,
                             plane_tol=0.2, huber_delta=0.5, trim_rel=0.0, trim_floor=0.5,
                             trim_after=4, degen_thresh=100.0, degen_rel=0.01, damping=1e-4,
                             trans_converged=5e-4, rot_converged=1e-3, reassociate_every=2)
KAPPA = 1e7
INF = float("inf")


def knn(q, r, r_mask, k, chunk=4096):
    """Squared distances (Q,k), ascending, and neighbour coordinates (Q,k,3)
    of each query among the valid references (INF where fewer exist)."""
    d_out, n_out = [], []
    rv = torch.where(r_mask[:, None], r, 0.0)
    for s in range(0, q.shape[0], chunk):
        qq = q[s:s + chunk]
        d = torch.sum((qq[:, None, :] - rv[None, :, :]) ** 2, dim=-1) if r.shape[0] <= 2048 else (
            torch.cdist(qq, rv) ** 2)
        d = torch.where(r_mask[None, :], d, INF)
        kk = min(k, r.shape[0])
        dv, idx = torch.topk(d, kk, dim=1, largest=False, sorted=True)
        if kk < k:
            dv = torch.cat([dv, torch.full((dv.shape[0], k - kk), INF, dtype=dv.dtype,
                                           device=dv.device)], 1)
            idx = torch.cat([idx, idx.new_zeros(idx.shape[0], k - kk)], 1)
        d_out.append(dv)
        n_out.append(rv[idx])
    return torch.cat(d_out), torch.cat(n_out)


def _edge_corr(p, qm, mxyz, mmask, prm):
    k = prm["k_neighbors"]
    d, nbr = knn(p, mxyz, mmask, k)
    ok = d < INF
    n_nbr = ok.sum(1)
    wsum = n_nbr.clamp(min=1)[:, None].to(p.dtype)
    cen = torch.sum(torch.where(ok[..., None], nbr, 0.0), 1) / wsum
    diff = torch.where(ok[..., None], nbr - cen[:, None], 0.0)
    cov = torch.einsum("nki,nkj->nij", diff, diff) / wsum[..., None]
    ev, evec = torch.linalg.eigh(cov)
    dirn = evec[..., 2]
    line_ok = ev[:, 2] > prm["edge_eig_ratio"] * ev[:, 1].clamp(min=1e-9)
    pc = p - cen
    perp = pc - torch.sum(pc * dirn, -1, keepdim=True) * dirn
    dist = torch.linalg.vector_norm(perp, dim=-1)
    n = perp / dist[:, None].clamp(min=1e-9)
    off = -torch.sum(n * (p - perp), -1)
    valid = qm & line_ok & (n_nbr >= k) & (d[:, k - 1] < prm["max_corr_dist"] ** 2)
    return (torch.where(valid[:, None], torch.nan_to_num(n), 0.0),
            torch.where(valid, torch.nan_to_num(off), 0.0), valid)


def _surf_corr(p, qm, mxyz, mmask, prm):
    k = prm["k_neighbors"]
    d, nbr = knn(p, mxyz, mmask, k)
    ok = d < INF
    w = ok.to(p.dtype)
    wsum = w.sum(1, keepdim=True).clamp(min=1.0)
    cen = torch.sum(nbr * w[..., None], 1) / wsum
    diff = (nbr - cen[:, None]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", diff, diff) / wsum[..., None]
    _, evec = torch.linalg.eigh(cov)
    n = evec[..., 0]
    off = -torch.sum(n * cen, -1)
    pd = torch.abs(torch.einsum("nki,ni->nk", nbr, n) + off[:, None])
    plane_ok = torch.all(torch.where(ok, pd < prm["plane_tol"], True), 1)
    valid = qm & plane_ok & (ok.sum(1) >= k) & (d[:, k - 1] < prm["max_corr_dist"] ** 2)
    return (torch.where(valid[:, None], torch.nan_to_num(n), 0.0),
            torch.where(valid, torch.nan_to_num(off), 0.0), valid)


def _normal_eq(p_src, n, r, w, R):
    nR = n @ R
    J = torch.cat([torch.linalg.cross(p_src, nR, dim=-1), nR], -1)
    return (J * w[:, None]).T @ J, J.T @ (r * w)


def _projector(H, nmatch, prm):
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    ev, V = torch.linalg.eigh(H + prm["damping"] * eye)
    floor = prm["degen_rel"] * nmatch if prm["degen_rel"] > 0 else prm["degen_thresh"]
    ok = (ev > floor).to(H.dtype)
    return (V * ok[None, :]) @ V.T


def register(src_edge, src_surf, map_edge, map_surf, init_pose, params: dict):
    """Pose (7,) of the source features (sensor frame) in the map's frame.
    Clouds are (xyz, mask) pairs; all arrays of one dtype."""
    prm = dict(REGISTRATION_DEFAULTS, **params)
    (ex, em), (sx, sm) = src_edge, src_surf
    dt, dev = ex.dtype, ex.device
    eye = torch.eye(6, dtype=dt, device=dev)
    pose = init_pose.to(dt)
    P = eye
    corr = None
    for i in range(prm["max_iters"]):
        pe = se3.apply(pose, ex)
        ps = se3.apply(pose, sx)
        assoc = i % prm["reassociate_every"] == 0
        if assoc:
            corr = (*_edge_corr(pe, em, *map_edge, prm), *_surf_corr(ps, sm, *map_surf, prm))
        ne, de, ve, ns, ds, vs = corr
        R = se3.qmat(pose[:4])
        re = torch.sum(ne * pe, -1) + de
        rs = torch.sum(ns * ps, -1) + ds

        def huber(r):
            a = torch.abs(r)
            return torch.where(a <= prm["huber_delta"], 1.0, prm["huber_delta"] / a.clamp(min=1e-12))

        we, ws = huber(re) * ve, huber(rs) * vs
        if prm["trim_rel"] > 0.0 and i >= prm["trim_after"]:
            av = torch.cat([torch.where(ve, torch.abs(re), INF), torch.where(vs, torch.abs(rs), INF)])
            nv = int(ve.sum() + vs.sum())
            med = torch.sort(av).values[max(nv - 1, 0) // 2] if nv > 0 else av.new_zeros(())
            cut = torch.clamp(prm["trim_rel"] * med, min=prm["trim_floor"])
            we = we * (torch.abs(re) <= cut)
            ws = ws * (torch.abs(rs) <= cut)
        He, ge = _normal_eq(ex, ne, re, we, R)
        Hs, gs = _normal_eq(sx, ns, rs, ws, R)
        H, g = He + Hs, ge + gs
        nmatch = int(ve.sum() + vs.sum())
        if assoc:
            P = _projector(H, nmatch, prm)
        A = H + prm["damping"] * eye + KAPPA * (eye - P)
        xi = P @ torch.linalg.solve(A, -g)
        pose = se3.retract(pose, xi)
        if (torch.linalg.vector_norm(xi[:3]) < prm["rot_converged"]
                and torch.linalg.vector_norm(xi[3:]) < prm["trans_converged"]):
            break
    return pose
