"""The registration's degeneracy projector: the hand-written CUDA kernel and
its plain torch versions.

Counterpart of the eigen-analysis in the reference's
``lmsf_slam_tpu/ops/registration.py::_degeneracy_projector``
(``jnp.linalg.eigh``). For a 6×6 normal matrix JᵀWJ it returns the projector
onto the directions whose eigenvalue lies above the degeneracy floor, and how
many there are (see :func:`projector_plain` for the function).

- CUDA tensors go to :func:`projector_cuda` — ``csrc/projector.cu``: a
  screen (one LDLᵀ that proves every eigenvalue above the floor, then P = I),
  else cyclic Jacobi in float64, one thread a matrix. It reads nothing back
  (``torch.linalg.eigh`` on the card copies to the host twice and waits at
  every association), and launches or raises; there is no fallback.
- CPU tensors go to :func:`projector_plain` (``torch.linalg.eigh``).

:func:`projector_jacobi_plain` (with :func:`projector_screen_plain`) is a
plain torch model of the kernel, operation for operation (the same screen,
rotations, order and stopping rule), so the kernel's arithmetic is testable
without a card.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_KERNEL = "projector"
THREADS = 128  # mirrors csrc/projector.cu (checked when the library loads)
MAX_SWEEPS = 30
SCREEN_ULPS = 384  # the screen's margin η = SCREEN_ULPS · EPS · (‖A‖∞ + |m|)
EPS = 2.220446049250313e-16

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _threshold(nmatch, degen_rel: float, degen_thresh: float, shape, dev):
    """The floor in float32: ``degen_rel · nmatch`` or ``degen_thresh``."""
    if nmatch is not None:
        return degen_rel * nmatch.to(torch.float32)
    return torch.full(shape, degen_thresh, dtype=torch.float32, device=dev)


def projector_plain(H, nmatch, damping: float, degen_rel: float, degen_thresh: float):
    """The plain version: H (..., 6, 6) → (P (..., 6, 6) float64, n_con
    (...) int32). ``A = (H if finite else I) + damping·I`` in float64, its
    eigenvectors kept where the eigenvalue, rounded to float32, exceeds the
    floor (``degen_rel · nmatch`` when ``nmatch`` is given, else
    ``degen_thresh``). A non-finite H gives a NaN projector and 0 directions,
    as the reference's ``eigh`` does; ``torch.linalg.eigh`` would raise on
    it, so it sees the identity instead."""
    H = H.to(torch.float64)
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    finite = torch.all(torch.isfinite(H), dim=(-2, -1))
    eigval, eigvec = torch.linalg.eigh(torch.where(finite[..., None, None], H, eye)
                                       + damping * eye)
    thresh = _threshold(nmatch, degen_rel, degen_thresh, finite.shape, H.device)
    ok = (eigval.to(torch.float32) > thresh[..., None]) & finite[..., None]
    P = (eigvec * ok[..., None, :].to(eigvec.dtype)) @ eigvec.transpose(-2, -1)
    return (torch.where(finite[..., None, None], P, torch.nan),
            torch.sum(ok, dim=-1, dtype=torch.int32))


def _kernel_input(H, nmatch, damping, degen_rel, degen_thresh):
    """(A float64 from H's lower triangle, finite, the float32 floor), as the
    kernel forms them."""
    H = H.to(torch.float64)
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    finite = torch.all(torch.isfinite(H), dim=(-2, -1))
    lower = torch.ones(6, 6, dtype=torch.bool, device=H.device).tril()
    H = torch.where(lower, H, H.transpose(-2, -1))
    a = torch.where(finite[:, None, None], H, eye) + damping * eye
    return a, finite, _threshold(nmatch, degen_rel, degen_thresh, finite.shape, H.device)


def projector_screen_plain(H, nmatch, damping: float, degen_rel: float,
                           degen_thresh: float):
    """The kernel's screen on each matrix of (B, 6, 6): True where the LDLᵀ
    of ``A − (m + η)·I`` has six positive pivots, m the float64 midpoint of
    the floor and the next float32 above it, ``η = SCREEN_ULPS·EPS·(‖A‖∞ +
    |m|)``; then every eigenvalue clears the floor and P = I (the margin's
    derivation is in ``csrc/projector.cu``). Each operation as the kernel
    rounds it; never True for a non-finite H."""
    a, finite, thresh = _kernel_input(H, nmatch, damping, degen_rel, degen_thresh)
    up = torch.nextafter(thresh, torch.full_like(thresh, torch.inf))
    mid = 0.5 * (thresh.to(torch.float64) + up.to(torch.float64))
    norm = torch.zeros_like(mid)
    for i in range(6):
        row = torch.zeros_like(mid)
        for j in range(6):
            row = row + torch.abs(a[:, i, j])
        norm = torch.maximum(norm, row)
    shift = mid + SCREEN_ULPS * EPS * (norm + torch.abs(mid))
    w, lo = {}, {}
    pd = finite & torch.isfinite(shift)
    for j in range(6):
        d = a[:, j, j] - shift
        for k in range(j):
            d = d - w[j, k] * lo[j, k]
        pd = pd & (d > 0.0)
        rd = 1.0 / d
        for i in range(j + 1, 6):
            x = a[:, i, j]
            for k in range(j):
                x = x - w[i, k] * lo[j, k]
            w[i, j], lo[i, j] = x, x * rd
    return pd


def projector_jacobi_plain(H, nmatch, damping: float, degen_rel: float,
                           degen_thresh: float, screen: bool = True):
    """Plain torch model of the kernel on each matrix of (B, 6, 6), operation
    for operation: the screen (``projector_screen_plain``; P = I, 6
    directions and 0 sweeps where it passes), then cyclic Jacobi: the pairs
    in row order, a rotation only where ``|a_pq| > EPS·sqrt(|a_pp a_qq|)``,
    until a sweep rotates nothing (or MAX_SWEEPS). ``screen=False`` runs
    Jacobi on every matrix. Returns (P, n_con, sweeps). Slow; for tests."""
    a, finite, thresh = _kernel_input(H, nmatch, damping, degen_rel, degen_thresh)
    B, dev = a.shape[0], a.device
    screened = (projector_screen_plain(H, nmatch, damping, degen_rel, degen_thresh) if screen
                else torch.zeros(B, dtype=torch.bool, device=dev))
    v = torch.eye(6, dtype=a.dtype, device=dev).expand(B, 6, 6).clone()
    sweeps = torch.zeros(B, dtype=torch.int32, device=dev)
    active = ~screened
    for _ in range(MAX_SWEEPS):
        if not bool(active.any()):
            break
        rotated = torch.zeros(B, dtype=torch.bool, device=dev)
        for p in range(6):
            for q in range(p + 1, 6):
                apq, app, aqq = a[:, p, q], a[:, p, p], a[:, q, q]
                do = active & (torch.abs(apq) > EPS * torch.sqrt(torch.abs(app * aqq)))
                if not bool(do.any()):
                    continue
                rotated |= do
                theta = (aqq - app) / (2.0 * torch.where(do, apq, 1.0))
                t = torch.where(torch.abs(theta) > 1e150, 0.5 / theta,
                                torch.copysign(torch.ones_like(theta), theta)
                                / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0)))
                c = 1.0 / torch.sqrt(t * t + 1.0)
                s = t * c
                tau = s / (1.0 + c)
                new = a.clone()
                new[:, p, p] = app - t * apq
                new[:, q, q] = aqq + t * apq
                new[:, p, q] = new[:, q, p] = 0.0
                for k in [k for k in range(6) if k not in (p, q)]:
                    akp, akq = a[:, k, p], a[:, k, q]
                    new[:, k, p] = new[:, p, k] = akp - s * (akq + tau * akp)
                    new[:, k, q] = new[:, q, k] = akq + s * (akp - tau * akq)
                vp, vq, vnew = v[:, :, p], v[:, :, q], v.clone()
                vnew[:, :, p] = vp - s[:, None] * (vq + tau[:, None] * vp)
                vnew[:, :, q] = vq + s[:, None] * (vp - tau[:, None] * vq)
                a = torch.where(do[:, None, None], new, a)
                v = torch.where(do[:, None, None], vnew, v)
        sweeps += rotated.to(torch.int32)
        active &= rotated
    lam = torch.diagonal(a, dim1=-2, dim2=-1).to(torch.float32)
    ok = (lam > thresh[:, None]) & finite[:, None]
    P = (v * ok[:, None, :].to(v.dtype)) @ v.transpose(-2, -1)
    P = torch.where(screened[:, None, None], torch.eye(6, dtype=P.dtype, device=dev), P)
    n_con = torch.where(screened, 6, torch.sum(ok, dim=-1, dtype=torch.int32))
    return (torch.where(finite[:, None, None], P, torch.nan), n_con.to(torch.int32), sweeps)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_typed: set[str] = set()


def _library():
    """``csrc/projector.cu`` built and loaded at first use, its entry points
    typed (an untyped pointer argument would be cut to 32 bits)."""
    lib = _build.load(_KERNEL)
    if _KERNEL in _typed:
        return lib
    with _build.lock:
        if _KERNEL in _typed:
            return lib
        for name, argtypes in (
            ("projector_launch", [_PTR, _PTR, _INT, ctypes.c_double, ctypes.c_float,
                                  ctypes.c_float, _PTR, _PTR, _PTR, _PTR]),
            ("projector_threads", []), ("projector_max_sweeps", []),
            ("projector_screen_ulps", []),
        ):
            fn = getattr(lib, name)
            fn.restype = _INT
            fn.argtypes = argtypes
        built = (lib.projector_threads(), lib.projector_max_sweeps(),
                 lib.projector_screen_ulps())
        if built != (THREADS, MAX_SWEEPS, SCREEN_ULPS):
            raise RuntimeError(f"projector.cu was built with {built}, the wrapper expects "
                               f"{(THREADS, MAX_SWEEPS, SCREEN_ULPS)}")
        _typed.add(_KERNEL)
    return lib


def projector_cuda(H, nmatch, damping: float, degen_rel: float, degen_thresh: float,
                   sweeps: bool = False):
    """Launch the kernel on H (..., 6, 6) float32 on a card, ``nmatch`` (...)
    int32 or None. Returns (P (..., 6, 6) float64, n_con (...) int32), and
    with ``sweeps`` the Jacobi sweeps each matrix took as well (0 where the
    screen passed)."""
    dev = H.device
    if dev.type != "cuda":
        raise ValueError(f"the projector kernel needs a CUDA tensor, got {dev}")
    if H.dtype != torch.float32 or H.shape[-2:] != (6, 6):
        raise ValueError(f"H must be a float32 (..., 6, 6) tensor, got {H.dtype} "
                         f"{tuple(H.shape)}")
    batch = H.shape[:-2]
    Hc = H.contiguous()
    B = Hc.numel() // 36
    if B == 0:
        raise ValueError("nothing to launch for an empty batch")
    nm = None
    if nmatch is not None:
        if nmatch.device != dev or tuple(nmatch.shape) != tuple(batch):
            raise ValueError(f"nmatch must be a {tuple(batch)} tensor on {dev}, got "
                             f"{tuple(nmatch.shape)} on {nmatch.device}")
        nm = nmatch.to(torch.int32).contiguous()
    P = torch.empty((*batch, 6, 6), dtype=torch.float64, device=dev)
    n_con = torch.empty(batch, dtype=torch.int32, device=dev)
    sw = torch.empty(batch, dtype=torch.int32, device=dev) if sweeps else None
    lib = _library()
    with _build.on_device(dev):
        rc = lib.projector_launch(
            Hc.data_ptr(), None if nm is None else nm.data_ptr(), B, float(damping),
            float(degen_rel), float(degen_thresh), P.data_ptr(), n_con.data_ptr(),
            None if sw is None else sw.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"projector kernel launch failed: CUDA error {rc}")
    _build.count_launch(_KERNEL)
    return (P, n_con, sw) if sweeps else (P, n_con)


def degeneracy_projector(H, nmatch, damping: float, degen_rel: float, degen_thresh: float):
    """(P float64, n_con int32) of H (..., 6, 6): the kernel serves CUDA
    tensors, CPU tensors take the plain version."""
    if H.device.type == "cpu":
        return projector_plain(H, nmatch, damping, degen_rel, degen_thresh)
    return projector_cuda(H, nmatch, damping, degen_rel, degen_thresh)
