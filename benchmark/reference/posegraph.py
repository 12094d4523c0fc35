"""Pose-graph least squares, plain PyTorch in float64: between edges with
residual ``log(z⁻¹ ∘ (xᵢ⁻¹ ∘ xⱼ))`` whitened by √information, a huber kernel
(scale ``delta`` on the whitened norm) on loop edges only, vertex 0 fixed;
Gauss-Newton on the dense normal equations with Jacobians by forward-mode
autodiff, run to convergence."""
from __future__ import annotations

import torch

from . import se3


def _res(x, pi, pj, z):
    return se3.log(se3.between(z, se3.between(se3.retract(pi, x[:6]), se3.retract(pj, x[6:]))))


def solve(poses, eij, z, sqrtw, loop, delta=10.0, iters=30, tol=1e-10):
    """Optimised poses (V,7) from ``poses``; ``eij`` (E,2) long, ``z`` (E,7),
    ``sqrtw`` (E,6), ``loop`` (E,) bool, one dtype and device."""
    V = poses.shape[0]
    x = poses.clone()
    jac = torch.func.vmap(torch.func.jacfwd(_res))
    for _ in range(iters):
        pi, pj = x[eij[:, 0]], x[eij[:, 1]]
        x0 = torch.zeros(eij.shape[0], 12, dtype=x.dtype, device=x.device)
        r = torch.func.vmap(_res)(x0, pi, pj, z) * sqrtw
        J = jac(x0, pi, pj, z) * sqrtw[..., None]
        a = torch.linalg.vector_norm(r, dim=-1)
        w = torch.where(loop & (a > delta), delta / a.clamp(min=1e-30), 1.0)
        H = torch.zeros(6 * V, 6 * V, dtype=x.dtype, device=x.device)
        g = torch.zeros(6 * V, dtype=x.dtype, device=x.device)
        idx = torch.stack([6 * eij[:, 0], 6 * eij[:, 1]], 1)[..., None] + torch.arange(
            6, device=x.device)
        cols = idx.reshape(-1, 12)
        Jw = J * w[:, None, None]
        Hb = torch.einsum("eai,eaj->eij", Jw, J)
        gb = torch.einsum("eai,ea->ei", Jw, r)
        H.index_put_((cols[:, :, None].expand(-1, 12, 12), cols[:, None, :].expand(-1, 12, 12)),
                     Hb, accumulate=True)
        g.index_put_((cols,), gb, accumulate=True)
        free = torch.ones(6 * V, dtype=torch.bool, device=x.device)
        free[:6] = False
        Hf = H[free][:, free] + 1e-9 * torch.eye(int(free.sum()), dtype=x.dtype, device=x.device)
        dx = torch.zeros(6 * V, dtype=x.dtype, device=x.device)
        dx[free] = torch.linalg.solve(Hf, -g[free])
        x = se3.retract(x, dx.reshape(V, 6))
        if float(torch.max(torch.abs(dx))) < tol:
            break
    return x
