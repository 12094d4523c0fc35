"""SE(3) pose-graph optimization: Gauss-Newton + block-Jacobi PCG on torch tensors.

Counterpart of ``lmsf_slam_tpu/backend/pose_graph.py``. The normal equations
are never materialized: each Gauss-Newton step runs matrix-free
preconditioned conjugate gradients where the Hessian-vector product is two
batched (E,6,6) einsums plus ``index_add_`` scatters, and the preconditioner
is the inverted per-vertex 6×6 diagonal block. Shapes are static (padded
vertex / edge capacity); padded edges point at vertex 0 with their mask off,
so they add exact zeros. Per-edge Jacobians come from forward-mode autodiff
of the boxplus residual (``torch.func.vmap(torch.func.jacfwd(...))`` over
:mod:`..common.se3`), so they are exact for any retraction.

The reference runs both loops as ``lax.while_loop`` with data-dependent
exits. Here they are Python loops that keep its arithmetic: a PCG iteration
the reference would not run is frozen with ``torch.where`` and changes
nothing, and the exit flag is read back only every ``PCG_CHECK_EVERY``
iterations; the GN loop reads its ``done`` flag once an iteration. A solve
thus synchronises with the card at most ``gn_iters · (1 + pcg_iters /
PCG_CHECK_EVERY)`` times instead of once per PCG iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..common import se3

# PCG iterations between two reads of the convergence flag
PCG_CHECK_EVERY = 8


class PoseGraphParams(NamedTuple):
    gn_iters: int = 12
    pcg_iters: int = 64
    damping: float = 1e-3  # LM diagonal damping added to H
    # Robust kernel policy: the kernel below applies only to edges flagged in
    # ``edges_robust`` (all edges if the caller passes none) — odometry edges
    # stay un-robustified and only loop closures get a kernel.
    #
    # ``huber`` is the default: its influence does NOT redescend, so a loop
    # closure at meters of whitened drift keeps pulling with constant force
    # instead of being switched off. For regimes where gross outlier edges
    # can enter the graph (no upstream verification), use ``tls`` +
    # ``gnc_iters>0``: annealed truncation that cuts any edge standing out
    # from the consensus of its peers.
    kernel: str = "huber"  # "none" | "huber" | "cauchy" | "dcs" | "tls"
    # kernel scale on the whitened edge error norm: a converged, correctly
    # whitened 6-dof edge has ‖r‖ ≈ √6 ≈ 2.45; 10.0 (≈1 m at the default
    # loop-edge σ=0.1 m) keeps every plausible converged loop at full
    # weight and only tempers edges the solved graph still contradicts
    kernel_delta: float = 10.0
    # graduated non-convexity (for the redescending kernels): for the
    # first ``gnc_iters`` GN iterations the kernel scale decays
    # geometrically from ``gnc_mu0``·delta to delta, so everything pulls
    # while the graph is far from converged. 0 disables.
    gnc_iters: int = 0
    gnc_mu0: float = 1e3
    # per-vertex trust clamp on each GN increment: an outlier edge (or the
    # GNC convex phase) must bend the graph gradually, not tear it apart in
    # one unclamped 40 m Newton step it can never recover from
    max_step_rot: float = 0.5  # rad per vertex per GN iteration
    max_step_trans: float = 5.0  # m per vertex per GN iteration
    converged_dx: float = 1e-5
    pcg_tol: float = 1e-8


class PoseGraphStats(NamedTuple):
    chi2_initial: torch.Tensor
    chi2_final: torch.Tensor
    iterations: torch.Tensor  # int32


def edge_residual(pose_i, pose_j, z):
    """Whitened-free between residual r = log(z⁻¹ ∘ (xᵢ⁻¹ ∘ xⱼ)) ∈ ℝ⁶."""
    return se3.pose_log(se3.pose_between(z, se3.pose_between(pose_i, pose_j)))


def _edge_boxplus(x, pose_i, pose_j, z):
    """Residual after right-perturbing both endpoints by x = [δᵢ, δⱼ]."""
    return edge_residual(
        se3.pose_retract(pose_i, x[..., :6]), se3.pose_retract(pose_j, x[..., 6:]), z
    )


def _edge_res_jac(pose_i, pose_j, z):
    """Residual (E,6) and Jacobians (E,6,6) wrt right-perturbations of both
    endpoints, for a batch of edges."""
    x0 = pose_i.new_zeros(pose_i.shape[:-1] + (12,))
    r = _edge_boxplus(x0, pose_i, pose_j, z)
    J = torch.func.vmap(torch.func.jacfwd(_edge_boxplus))(x0, pose_i, pose_j, z)  # (E,6,12)
    return r, J[..., :6], J[..., 6:]


def _robust_weight(r2, kernel: str, delta):
    """IRLS weight as a function of squared whitened edge error norm.

    ``huber`` keeps a non-redescending influence (outliers are tempered,
    never switched off); ``dcs`` (dynamic covariance scaling) redescends and
    should be paired with the GNC schedule when initial drift is large.
    ``delta`` may be a tensor (the consensus-median floor makes it one).
    """
    if kernel == "none":
        return torch.ones_like(r2)
    if kernel == "huber":
        a = torch.sqrt(torch.clamp(r2, min=1e-12))
        return torch.where(a <= delta, 1.0, delta / a)
    if kernel == "cauchy":
        return 1.0 / (1.0 + r2 / (delta * delta))
    if kernel == "dcs":
        phi = delta * delta
        return torch.clamp(2.0 * phi / (phi + r2), max=1.0)
    if kernel == "tls":
        # truncated least squares: full weight inside the (annealed)
        # threshold, zero outside — pair with gnc_iters > 0 so the
        # threshold starts far beyond any plausible drift
        return (r2 <= delta * delta).to(r2.dtype)
    raise ValueError(f"unknown robust kernel: {kernel}")


def _gnc_delta(params: "PoseGraphParams", t: int) -> float:
    """Annealed kernel scale at GN iteration ``t``.

    delta_t = delta · mu0^(max(0, 1 − t/gnc_iters)) — near-quadratic at
    t=0, the true kernel from t = gnc_iters on. Identity when disabled.
    Evaluated in float32, as the reference evaluates it.
    """
    if params.gnc_iters <= 0:
        return float(np.float32(params.kernel_delta))
    frac = np.maximum(np.float32(0.0), np.float32(1.0) - np.float32(t) / np.float32(params.gnc_iters))
    return float(np.float32(params.kernel_delta) * np.power(np.float32(params.gnc_mu0), frac))


def _clamp_step(dx, params: "PoseGraphParams"):
    """Per-vertex trust clamp of a (V, 6) GN increment [rot, trans]."""
    rot_n = torch.linalg.vector_norm(dx[:, :3], dim=-1)
    trn_n = torch.linalg.vector_norm(dx[:, 3:], dim=-1)
    scale = torch.clamp(
        torch.minimum(
            params.max_step_rot / torch.clamp(rot_n, min=1e-9),
            params.max_step_trans / torch.clamp(trn_n, min=1e-9),
        ),
        max=1.0,
    )
    return dx * scale[:, None]


def _edge_weights(r2, erobust, emask, params: "PoseGraphParams", t: int):
    """Per-edge IRLS weight: robust kernel only where ``erobust`` is set
    (loop edges); odometry edges keep weight 1.

    The effective kernel scale is the GNC-annealed delta, floored by 3× the
    (lower) median residual norm of the robust edges: while the whole edge
    population is still far from convergence (trust-clamped graph mid-bend)
    nothing is truncated; an edge is only cut once it stands out from the
    consensus of its peers.
    """
    delta = _gnc_delta(params, t)
    if params.kernel in ("tls", "dcs", "cauchy"):
        valid = erobust & emask
        rn = torch.sqrt(torch.clamp(r2, min=0.0))
        n_valid = torch.sum(valid)
        srt = torch.sort(torch.where(valid, rn, torch.inf)).values
        mid = (torch.clamp(n_valid - 1, min=0) // 2).reshape(1)
        med = srt.index_select(0, mid)[0]
        med = torch.where(n_valid > 0, med, 0.0)
        delta = torch.clamp(3.0 * med, min=delta)
    wk = _robust_weight(r2, params.kernel, delta)
    return torch.where(erobust, wk, 1.0)


# -- unary factor residuals: fn(x (…,6), pose (…,7), z, sqrtw) → (…,3) ------


def _xyz_res(x, pose, z, sqrtw):
    return (se3.pose_retract(pose, x)[..., 4:] - z) * sqrtw


def _quat_res(x, pose, z, sqrtw):
    q = se3.pose_quat(se3.pose_retract(pose, x))
    return se3.so3_log(se3.quat_mul(se3.quat_conj(z), q)) * sqrtw


def _plane_res(x, pose, z, sqrtw):
    p = se3.pose_retract(pose, x)
    ez = torch.zeros_like(p[..., 4:])
    ez[..., 2] = 1.0
    a = se3.quat_rotate(se3.pose_quat(p), ez)
    return torch.stack([p[..., 6] - z, a[..., 0], a[..., 1]], dim=-1) * sqrtw


def _unary_res_jac(fn, pose, z, sqrtw):
    """Residual (K,3) and Jacobian (K,3,6) of a batch of unary factors."""
    x0 = pose.new_zeros(pose.shape[:-1] + (6,))
    r = fn(x0, pose, z, sqrtw)
    J = torch.func.vmap(torch.func.jacfwd(fn))(x0, pose, z, sqrtw)
    return r, J


def _segment_sum(values, idx, num_segments: int):
    """Σ of ``values`` rows by ``idx`` (the reference's ``segment_sum``):
    every row is added, masked rows having been zeroed by their weight."""
    out = values.new_zeros((num_segments,) + values.shape[1:])
    return out.index_add_(0, idx, values)


def optimize_pose_graph(
    poses: torch.Tensor,  # (V, 7)
    vmask: torch.Tensor,  # (V,) bool — vertex exists
    edges_ij: torch.Tensor,  # (E, 2) int32
    edges_z: torch.Tensor,  # (E, 7) measured relative pose i→j
    edges_sqrtw: torch.Tensor,  # (E, 6) per-dim sqrt information (1/σ)
    emask: torch.Tensor,  # (E,) bool — edge exists
    fixed: torch.Tensor | None = None,  # (V,) bool — gauge-fixed vertices
    edges_robust: torch.Tensor | None = None,  # (E,) bool — kernel applies
    prior_xyz: torch.Tensor | None = None,  # (K,3) absolute position priors
    prior_idx: torch.Tensor | None = None,  # (K,) vertex ids
    prior_sqrtw: torch.Tensor | None = None,  # (K,3)
    prior_mask: torch.Tensor | None = None,  # (K,)
    qprior_quat: torch.Tensor | None = None,  # (K,4) absolute orientation priors
    qprior_idx: torch.Tensor | None = None,  # (K,) vertex ids
    qprior_sqrtw: torch.Tensor | None = None,  # (K,3)
    qprior_mask: torch.Tensor | None = None,  # (K,)
    plane_idx: torch.Tensor | None = None,  # (K,) vertex ids on the floor plane
    plane_z: torch.Tensor | None = None,  # (K,) plane height per constraint
    plane_sqrtw: torch.Tensor | None = None,  # (K,3) [z, roll-pitch, roll-pitch]
    plane_mask: torch.Tensor | None = None,  # (K,)
    params: PoseGraphParams = PoseGraphParams(),
):
    """Batch GN/LM solve. Returns (optimized_poses, PoseGraphStats).

    Unary factors (all optional, padded + masked):

    - ``prior_*``: absolute-position priors (GNSS constraints);
    - ``qprior_*``: absolute-orientation priors; residual = log(q_meas⁻¹ ⊗ q);
    - ``plane_*``: floor/plane factors; residual = [p_z − z_ref, a_x, a_y]
      with a = R·e_z, i.e. height above the plane plus roll/pitch deviation
      from plane-normal alignment.

    With any absolute factor the graph is anchored, so pass ``fixed`` of
    all-False to let every vertex move (the default still gauge-fixes
    vertex 0 for odometry-only graphs).
    """
    V = poses.shape[0]
    dev = poses.device
    if fixed is None:
        fixed = torch.zeros(V, dtype=torch.bool, device=dev)
        fixed[0] = True
    free = vmask & ~fixed
    erobust = torch.ones_like(emask) if edges_robust is None else edges_robust
    i_idx = edges_ij[:, 0].long()
    j_idx = edges_ij[:, 1].long()

    # unary factor groups: (residual fn, measurement, sqrtw, idx, mask)
    unary = []
    if prior_xyz is not None:
        unary.append((_xyz_res, prior_xyz, prior_sqrtw, prior_idx.long(), prior_mask))
    if qprior_quat is not None:
        unary.append((_quat_res, qprior_quat, qprior_sqrtw, qprior_idx.long(), qprior_mask))
    if plane_idx is not None:
        unary.append((_plane_res, plane_z, plane_sqrtw, plane_idx.long(), plane_mask))

    def chi2_of(p):
        r = edge_residual(p[i_idx], p[j_idx], edges_z) * edges_sqrtw
        c = torch.sum(torch.where(emask, torch.sum(r * r, -1), 0.0))
        for fn, z, sw, idx, msk in unary:
            pp = p[idx]
            ru = fn(pp.new_zeros(pp.shape[:-1] + (6,)), pp, z, sw)
            c = c + torch.sum(torch.where(msk, torch.sum(ru * ru, -1), 0.0))
        return c

    def gn_step(p, t: int):
        r, Ji, Jj = _edge_res_jac(p[i_idx], p[j_idx], edges_z)
        # whiten rows
        r = r * edges_sqrtw
        Ji = Ji * edges_sqrtw[:, :, None]
        Jj = Jj * edges_sqrtw[:, :, None]
        r2 = torch.sum(r * r, dim=-1)
        w = _edge_weights(r2, erobust, emask, params, t) * emask  # (E,)

        # unary factor linearizations: [(r (K,3), J (K,3,6), idx (K,))]
        lin = []
        for fn, z, sw, idx, msk in unary:
            ru, Ju = _unary_res_jac(fn, p[idx], z, sw)
            lin.append((ru * msk[:, None], Ju * msk[:, None, None], idx))

        def matvec(x):  # x: (V, 6)
            y = torch.einsum("eab,eb->ea", Ji, x[i_idx]) + torch.einsum(
                "eab,eb->ea", Jj, x[j_idx]
            )
            y = y * w[:, None]
            out = _segment_sum(torch.einsum("eab,ea->eb", Ji, y), i_idx, V) + _segment_sum(
                torch.einsum("eab,ea->eb", Jj, y), j_idx, V
            )
            for _, Ju, idx in lin:
                yu = torch.einsum("kab,kb->ka", Ju, x[idx])
                out = out + _segment_sum(torch.einsum("kab,ka->kb", Ju, yu), idx, V)
            out = out + params.damping * x
            return torch.where(free[:, None], out, 0.0)

        # gradient g = Jᵀ W r  (we solve H dx = -g)
        wr = r * w[:, None]
        g = _segment_sum(torch.einsum("eab,ea->eb", Ji, wr), i_idx, V) + _segment_sum(
            torch.einsum("eab,ea->eb", Jj, wr), j_idx, V
        )
        for ru, Ju, idx in lin:
            g = g + _segment_sum(torch.einsum("kab,ka->kb", Ju, ru), idx, V)
        g = torch.where(free[:, None], g, 0.0)

        # block-Jacobi preconditioner: per-vertex 6×6 diagonal blocks of H
        M = _segment_sum(torch.einsum("eab,eac,e->ebc", Ji, Ji, w), i_idx, V) + _segment_sum(
            torch.einsum("eab,eac,e->ebc", Jj, Jj, w), j_idx, V
        )
        for _, Ju, idx in lin:
            M = M + _segment_sum(torch.einsum("kab,kac->kbc", Ju, Ju), idx, V)
        M = M + (params.damping + 1e-6) * torch.eye(6, dtype=M.dtype, device=dev)
        Minv = torch.linalg.inv(M)

        def precond(x):
            return torch.where(free[:, None], torch.einsum("vab,vb->va", Minv, x), 0.0)

        # PCG for H dx = -g from x0 = 0, so r0 = b
        x = torch.zeros_like(g)
        rr = -g
        zz = precond(rr)
        pp = zz
        rz = torch.sum(rr * zz)
        rz0 = rz

        # early-exit PCG: residual-energy convergence relative to the initial
        # preconditioned residual. An iteration past the exit is frozen, so
        # reading the flag late changes nothing.
        for it in range(params.pcg_iters):
            active = torch.abs(rz) > params.pcg_tol * torch.abs(rz0)
            if it > 0 and it % PCG_CHECK_EVERY == 0 and not bool(active):
                break
            Ap = matvec(pp)
            pAp = torch.sum(pp * Ap)
            alpha = rz / torch.where(torch.abs(pAp) > 1e-20, pAp, 1e-20)
            x_new = x + alpha * pp
            rr_new = rr - alpha * Ap
            zz_new = precond(rr_new)
            rz_new = torch.sum(rr_new * zz_new)
            beta = rz_new / torch.where(torch.abs(rz) > 1e-20, rz, 1e-20)
            pp_new = zz_new + beta * pp
            x = torch.where(active, x_new, x)
            rr = torch.where(active, rr_new, rr)
            pp = torch.where(active, pp_new, pp)
            rz = torch.where(active, rz_new, rz)
        dx = _clamp_step(x, params)

        new_p = torch.where(free[:, None], se3.pose_retract(p, dx), p)
        dx_norm = torch.sqrt(torch.sum(dx * dx) / torch.clamp(torch.sum(free), min=1))
        # a small step during the GNC anneal is not convergence — the
        # surrogate is still changing under the iterate
        small = (dx_norm < params.converged_dx) & (t >= params.gnc_iters)
        return new_p, small

    chi2_0 = chi2_of(poses)
    # a converged solve exits instead of burning the remaining gn_iters: the
    # windowed per-batch re-solves of the lifelong backend typically converge
    # in a fraction of the budget
    p = poses
    iters = 0
    while iters < params.gn_iters:
        p, done = gn_step(p, iters)
        iters += 1
        if bool(done):
            break
    return p, PoseGraphStats(
        chi2_initial=chi2_0,
        chi2_final=chi2_of(p),
        iterations=torch.tensor(iters, dtype=torch.int32, device=dev),
    )
