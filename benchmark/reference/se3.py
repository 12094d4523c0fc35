"""SE(3) on poses ``[qw qx qy qz tx ty tz]`` and tangents ``[rot(3), trans(3)]``,
in plain PyTorch and in the dtype of the inputs (the reference runs float64).
The conventions are the system's: right retraction ``p ∘ exp(ξ)``,
``between(a, b) = a⁻¹ ∘ b``."""
from __future__ import annotations

import torch


def skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def qnorm(q):
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.where(q[..., :1] < 0, -q, q)


def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def qrot(q, v):
    qv = q[..., 1:].expand(v.shape)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + q[..., :1] * t + torch.linalg.cross(qv, t, dim=-1)


def qmat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                       -1).reshape(q.shape[:-1] + (3, 3))


def compose(a, b):
    return torch.cat([qnorm(qmul(a[..., :4], b[..., :4])),
                      qrot(a[..., :4], b[..., 4:]) + a[..., 4:]], -1)


def inverse(p):
    qi = qconj(p[..., :4])
    return torch.cat([qi, -qrot(qi, p[..., 4:])], -1)


def between(a, b):
    return compose(inverse(a), b)


def apply(p, pts):
    """Points (N,3) moved by one pose (7,)."""
    return pts @ qmat(p[:4]).T + p[4:]


def so3_log(q):
    q = qnorm(q)
    s = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(s, q[..., :1].clamp(-1.0, 1.0))
    k = torch.where(s < 1e-9, 2.0 + 0 * s, 2.0 * half / s.clamp(min=1e-30))
    return k * q[..., 1:]


def exp(xi):
    w, v = xi[..., :3], xi[..., 3:]
    th2 = torch.sum(w * w, -1, keepdim=True)
    th = torch.sqrt(th2.clamp(min=1e-30))
    small = th2 < 1e-10
    k = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * th) / th)
    q = qnorm(torch.cat([torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th)), k * w], -1))
    th2m, thm = th2[..., None], th[..., None]
    W = skew(w)
    A = torch.where(th2m < 1e-6, 0.5 - th2m / 24.0, (1 - torch.cos(thm)) / th2m.clamp(min=1e-30))
    B = torch.where(th2m < 1e-6, 1.0 / 6.0 - th2m / 120.0,
                    (thm - torch.sin(thm)) / (th2m * thm).clamp(min=1e-30))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    t = ((eye + A * W + B * (W @ W)) @ v[..., None])[..., 0]
    return torch.cat([q, t], -1)


def log(p):
    w = so3_log(p[..., :4])
    th2 = torch.sum(w * w, -1)[..., None, None]
    th = torch.sqrt(th2.clamp(min=1e-30))
    W = skew(w)
    coef = torch.where(th2 < 1e-6, 1.0 / 12.0 + th2 / 720.0,
                       (1.0 - th * torch.sin(th) / (2.0 * (1.0 - torch.cos(th))).clamp(min=1e-30))
                       / th2.clamp(min=1e-30))
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    v = ((eye - 0.5 * W + coef * (W @ W)) @ p[..., 4:, None])[..., 0]
    return torch.cat([w, v], -1)


def retract(p, xi):
    return compose(p, exp(xi))


def gap_m(a, b):
    """Translation gap (m) between poses (..., 7)."""
    return torch.linalg.vector_norm(a[..., 4:] - b[..., 4:], dim=-1)
