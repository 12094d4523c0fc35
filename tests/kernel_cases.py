"""Cases and comparisons of the port's hand-written kernels, shared by their
tests and by ``chip_smoke.py``: the k-NN kernels (``knn_case``,
``compare_knn``, ``threads_check``), the degeneracy projector (the boundary
batch, ``compare_projector`` against ``projector_plain`` and its CPU model,
the exact counts, the bound) and the ESKF propagation (``eskf_window``,
``eskf_start``, ``eskf_plain`` and the tolerances of ``eskf_gaps``).

It imports no JAX and nothing of the ``tests`` package, so the card tests and
``chip_smoke.py`` import it on the machine with the card, whose path holds a
foreign ``tests`` package: pytest puts this directory on ``sys.path`` for the
test files, and ``chip_smoke.py`` puts it there itself. Torch and the port
are imported inside the functions, as ``chip_smoke.py`` imports them.
"""
import numpy as np

# The H100 SXM's published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores and HBM3 bandwidth. Used for the bound only.
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12  # FP64 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

PROJECTOR_AGREE = 1e-9  # projector entries, kernel vs torch.linalg.eigh (both float64)
# the boundary batch: one launch a floor and an offset of the smallest
# eigenvalue from the float32 rounding midpoint above the floor
PROJECTOR_FLOORS = ("relative", "absolute", "no matches")
PROJECTOR_OFFSETS = ("at", "under", "over")
PROJECTOR_BOUNDARY = [f"{f} floor, {o} the midpoint" for f in PROJECTOR_FLOORS
                      for o in PROJECTOR_OFFSETS]
# which of the batch's five matrices the screen passes: the two with an
# eigenvalue at the midpoint no, the two clear of it yes, the non-finite no
PROJECTOR_BOUNDARY_SCREENED = (False, False, True, True, False)

# the ESKF kernel against its plain version, both float32 on the card (the
# reasons are in tests/test_torch_eskf_cuda.py): position and velocity within
# ESKF_ATOL + ESKF_RTOL·|x|, the attitude within ESKF_ANGLE rad, the biases
# equal, each covariance entry P_rc within ESKF_COV_ATOL + ESKF_COV_RTOL ·
# sqrt(P_rr P_cc), its own correlation's scale
ESKF_ATOL, ESKF_RTOL, ESKF_ANGLE = 1e-6, 1e-6, 1e-6
ESKF_COV_RTOL, ESKF_COV_ATOL = 1e-5, 1e-30


class CheckFailure(AssertionError):
    """A kernel's result disagrees with what it is held to."""


def check(cond, msg):
    if not cond:
        raise CheckFailure(msg)


def knn_case(Q, N, q_invalid, r_valid, seed, dev, dup=False):
    """Inputs from a seed. ``r_valid`` is a fraction of valid references, or
    an integer count of them. With ``dup`` every reference point is present
    four times, spread over the whole index range."""
    import torch

    g = np.random.default_rng(seed)
    q = g.standard_normal((Q, 3)) * 15.0
    r = g.standard_normal((N, 3)) * 15.0
    if dup:
        r = np.concatenate([r[: N // 4]] * 4)[g.permutation(4 * (N // 4))]
    if isinstance(r_valid, int):
        rm = np.zeros(r.shape[0], dtype=bool)
        rm[g.choice(r.shape[0], r_valid, replace=False)] = True
    else:
        rm = g.random(r.shape[0]) < r_valid
    q = torch.as_tensor(q, dtype=torch.float32, device=dev)
    r = torch.as_tensor(r, dtype=torch.float32, device=dev)
    qm = torch.arange(Q, device=dev) >= q_invalid
    return q, qm, r, torch.as_tensor(rm, device=dev)


def compare_knn(K, q, qm, r, rm, k, exact_model=False, dup=False, **kernel_args):
    """The whole function on the card: ``knn_cuda`` (the kernels) against
    ``knn_plain`` on the same inputs. Returns (max |Δd| over agreeing rows,
    near-tie rows).

    Distances must agree to rtol 1e-6: the kernel sums (dx² + dy²) + dz² with
    every product and sum rounded, the plain version through ``torch.sum``,
    so they may differ by the summation order of three terms (2–3 float32
    ulps). Indices must agree wherever a distance differs from its neighbours
    by more than 1e-6 relative. The plain version picks its candidates by the
    expansion |q|²+|p|²−2q·p, whose float32 rounding is up to
    ~8·2⁻²³·(|q|²+max|p|²); a row may differ only where the kernel's exact
    distances are no worse than the plain version's by more than that bound (a
    near-tie the expansion cannot resolve). Empty slots and masked queries
    must hold INF and index 0. With ``dup`` (references present several
    times) the plain version's ``topk`` may keep any copy of the point at the
    cut, so the neighbours' coordinates are compared there and the indices
    are left to the model below.

    With ``exact_model`` the kernels must also equal
    ``knn_split_merge_plain(splits=1, lanes=1)`` — one ascending scan ordered
    by (d, idx), with the kernel's own rounding — bit for bit, ties included.
    """
    import torch

    d_k, i_k, _ = K.knn_cuda(q, qm, r, rm, k, **kernel_args)
    d_r, i_r = K.knn_plain(q, qm, r, rm, k)
    torch.cuda.synchronize()
    check(d_k.shape == d_r.shape and i_k.dtype == torch.int32, "knn output shape or type")
    empty = d_k >= 1e30
    check(bool((i_k[empty] == 0).all()) and bool((d_k[empty] == K.INF).all()),
          "an empty slot does not hold INF and index 0")
    check(bool(empty[~qm].all()), "a masked query has a neighbour")
    close = torch.abs(d_k - d_r) <= 1e-6 * torch.abs(d_r)
    row_ok = close.all(dim=1)
    pmax = torch.max(torch.where(rm, torch.sum(r * r, dim=1), 0.0))
    tie_tol = 8.0 * 2.0**-23 * (torch.sum(q * q, dim=1) + pmax)
    tie_row = ~row_ok & (d_k <= d_r + tie_tol[:, None]).all(dim=1)
    n_bad = int((~row_ok & ~tie_row).sum())
    check(n_bad == 0, f"knn kernel disagrees with knn_plain on {n_bad} rows")
    n_tie = int(tie_row.sum())
    check(n_tie <= max(2, q.shape[0] // 100), f"too many near-tie rows: {n_tie}")
    big = torch.full_like(d_r[:, :1], float("inf"))
    gap_prev = torch.cat([big, d_r[:, 1:] - d_r[:, :-1]], dim=1)
    gap_next = torch.cat([d_r[:, 1:] - d_r[:, :-1], big], dim=1)
    rel = 1e-6 * torch.clamp(torch.abs(d_r), min=1e-30)
    distinct = (gap_prev > rel) & (gap_next > rel) & (d_r < 1e30) & row_ok[:, None]
    if dup:
        check(bool(torch.equal(r[i_k.long()][distinct], r[i_r.long()][distinct])),
              "knn neighbours disagree")
    else:
        check(bool(torch.equal(i_k[distinct], i_r[distinct])), "knn indices disagree")
    if exact_model:
        d_m, i_m = K.knn_split_merge_plain(q, qm, r, rm, k, splits=1, lanes=1)
        check(torch.equal(d_k, d_m) and torch.equal(i_k, i_m),
              "knn kernel differs from the single-scan model (ties or rounding)")
    finite = (d_r < 1e30) & row_ok[:, None]
    err = float(torch.max(torch.where(finite, torch.abs(d_k - d_r), 0.0))) if finite.any() else 0.0
    return err, n_tie


def threads_check(K, rounds=200):
    """The kernels launched from two threads at once, as the frontend and the
    backend's worker launch them (each thread takes the current stream and
    its scratch from the allocator on its own): every result must equal, bit
    for bit, the one the same inputs gave on one thread. Returns the number
    of launches compared."""
    import threading

    import torch

    dev = torch.device("cuda")
    jobs = []
    for seed, (Q, N, k) in enumerate(((1536, 8192, 5), (3072, 46080, 1))):
        q, qm, r, rm = knn_case(Q, N, 3, 0.7, seed=100 + seed, dev=dev)
        jobs.append((q, qm, r, rm, k, K.knn_cuda(q, qm, r, rm, k, neighbors=True)))
    torch.cuda.synchronize()
    failures = []

    def worker(job):
        q, qm, r, rm, k, want = job
        try:
            with torch.cuda.device(dev):
                for _ in range(rounds):
                    got = K.knn_cuda(q, qm, r, rm, k, neighbors=True)
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        failures.append(f"{tuple(q.shape)}x{tuple(r.shape)} k={k} differs")
                        return
        except Exception as exc:  # noqa: BLE001 - reported by the caller's check
            failures.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(job,)) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    torch.cuda.synchronize()
    check(not any(t.is_alive() for t in threads), "a launching thread did not finish")
    check(not failures, f"kernels launched from two threads at once: {failures}")
    return rounds * len(jobs)


# FP64 operations the function needs for one matrix: proving every
# eigenvalue above the floor (‖A‖∞: 36 additions and 6 maxima, the margin: 4,
# the LDLᵀ of a 6x6 matrix: 97), or else a 6x6 symmetric eigendecomposition
# (9n³, Golub & Van Loan §8.3) and the projector from it (432)
PROJECTOR_SCREEN_OPS = 143
PROJECTOR_EIGH_OPS = 9 * 6 ** 3 + 432


def projector_bound_ms(B, screened):
    """Least time on the card: the larger of the FP64 work the function
    needs on these inputs (the proof for the ``screened`` matrices, an
    eigendecomposition and P for the others; not the algorithm's sweeps) and
    the bytes (H and the match count read once, P and the count written
    once)."""
    ops = PROJECTOR_SCREEN_OPS * screened + PROJECTOR_EIGH_OPS * (B - screened)
    nbytes = B * (36 * 4 + 4 + 36 * 8 + 4)
    t_ops = ops / PEAK_FP64_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def projector_boundary_cases(device):
    """The boundary batch: {name: (H (5, 6, 6) float32, nmatch (5,) int32 or
    None, params)}, one launch for each floor (relative: 0.01 · 777 matches,
    whose float32 has an odd last bit, so a tie rounds up; absolute: 100,
    even, a tie rounds down; no matches: 0) and each place of the smallest
    eigenvalue: at the float64 midpoint between the floor and the next float32
    above it, 2^-21 of a float32 step under it, or over it. The matrices are
    diagonal, so their eigenvalues are exact: h + damping with h the floor
    itself and a dyadic damping of half a step (± 2^-21 of a step). Of the
    five matrices, 0 has the other eigenvalues at 1000 + 4·floor, 1 one of
    them at 1e30 (where the screen's margin is large), 2 all of them clear of
    the floor, 3 clear with a norm of 1e12, 4 is 2 with an infinite entry."""
    import torch

    from lmsf_slam_tpu_torch.ops.registration import RegistrationParams

    base = RegistrationParams()
    cases = {}
    for floor in PROJECTOR_FLOORS:
        n = {"relative": 777, "absolute": None, "no matches": 0}[floor]
        t = np.float32(base.degen_thresh) if n is None else (
            np.float32(base.degen_rel) * np.float32(n))
        step = float(np.nextafter(t, np.float32(np.inf))) - float(t)
        high = 1000.0 + 4.0 * float(t)
        diags = [[t] + [high + k for k in range(5)],
                 [t] + [high + k for k in range(4)] + [1e30],
                 [high + k for k in range(6)],
                 [high + k for k in range(5)] + [1e12],
                 [high + k for k in range(6)]]
        H = torch.diag_embed(torch.tensor(np.asarray(diags, dtype=np.float32), device=device))
        H[4, 0, 3] = float("inf")
        nm = None if n is None else torch.full((5,), n, dtype=torch.int32, device=device)
        for offset, sign in zip(PROJECTOR_OFFSETS, (0, -1, 1)):
            damping = step / 2 + sign * step * 2.0 ** -21
            cases[f"{floor} floor, {offset} the midpoint"] = (H, nm, base._replace(damping=damping))
    return cases


def projector_exact_count(H, nmatch, params):
    """Directions above the floor of a diagonal H, from its exact eigenvalues
    h_ii + damping; 0 where H is not finite."""
    import torch

    lam = torch.diagonal(H, dim1=-2, dim2=-1).to(torch.float64) + params.damping
    floor = (torch.full(lam.shape[:-1], params.degen_thresh, dtype=torch.float32, device=H.device)
             if nmatch is None else params.degen_rel * nmatch.to(torch.float32))
    finite = torch.all(torch.isfinite(H), dim=(-2, -1))
    ok = (lam.to(torch.float32) > floor[..., None]) & finite[..., None]
    return torch.sum(ok, dim=-1, dtype=torch.int32)


def compare_projector(PJ, H, nmatch, params, plain_on_cpu=False):
    """Kernel against ``projector_plain`` (``torch.linalg.eigh``) on the card:
    the same count of directions above the floor everywhere, NaN where H is
    not finite, and the projectors within PROJECTOR_AGREE (float64 Jacobi and
    cuSOLVER's decomposition agree to a few 1e-15 relative to the largest
    eigenvalue; a projector's entries are O(1)); P = I exactly where the
    screen passed. Then against its CPU model (``projector_jacobi_plain``),
    which repeats its arithmetic operation for operation: the same screen
    decisions and sweeps. Returns (max |ΔP|, sweeps, screened), the last two
    flat on the CPU. ``plain_on_cpu`` runs the plain version on the CPU
    (LAPACK), for inputs whose eigenvalues sit on a float32 rounding tie,
    where cuSOLVER's last bit decides the count."""
    import torch

    args = (params.damping, params.degen_rel, params.degen_thresh)
    P_k, n_k, sw = PJ.projector_cuda(H, nmatch, *args, sweeps=True)
    if plain_on_cpu:
        P_r, n_r = (x.to(H.device) for x in PJ.projector_plain(
            H.cpu(), None if nmatch is None else nmatch.cpu(), *args))
    else:
        P_r, n_r = PJ.projector_plain(H, nmatch, *args)
    torch.cuda.synchronize()
    check(P_k.dtype == torch.float64 and P_k.shape == P_r.shape, "projector output shape or type")
    check(torch.equal(n_k, n_r), f"projector counts differ: kernel {n_k.flatten()[:8].tolist()}, "
          f"plain {n_r.flatten()[:8].tolist()}")
    nan_r = torch.isnan(P_r)
    check(torch.equal(torch.isnan(P_k), nan_r), "projector NaNs differ from the plain version's")
    err = float(torch.max(torch.where(nan_r, 0.0, torch.abs(P_k - P_r))))
    check(err <= PROJECTOR_AGREE, f"projector differs from the plain version by {err:.3g} "
          f"(limit {PROJECTOR_AGREE})")
    Hc = H.cpu().reshape(-1, 6, 6)
    nc = None if nmatch is None else nmatch.cpu().reshape(-1)
    _, n_m, sw_m = PJ.projector_jacobi_plain(Hc, nc, *args)
    screened = PJ.projector_screen_plain(Hc, nc, *args)
    sw = sw.cpu().reshape(-1)
    check(torch.equal(n_k.cpu().reshape(-1), n_m), "projector counts differ from the CPU model's")
    check(torch.equal(sw, sw_m), f"projector sweeps differ from the CPU model's: kernel "
          f"{sw[:8].tolist()}, model {sw_m[:8].tolist()}")
    eye = torch.eye(6, dtype=torch.float64)
    check(bool(torch.all(P_k.cpu().reshape(-1, 6, 6)[screened] == eye)),
          "a screened matrix's projector is not the identity")
    return err, sw, screened


def eskf_gaps(got, want):
    """Each gap of an ESKF state ``got`` to ``want`` over its tolerance (the
    pair agrees where every value is ≤ 1): position and velocity, the biases
    (0 when equal, else inf), the attitude angle, and the covariance, each
    entry on the scale of its own correlation, sqrt(P_rr P_cc)."""
    import torch

    from lmsf_slam_tpu_torch.common import se3

    g = {}
    for k in ("p", "v"):
        a, b = getattr(got, k).double(), getattr(want, k).double()
        g[k] = float(torch.max(torch.abs(a - b) / (ESKF_ATOL + ESKF_RTOL * torch.abs(b))))
    for k in ("ba", "bg"):
        g[k] = 0.0 if torch.equal(getattr(got, k), getattr(want, k)) else float("inf")
    dq = se3.so3_log(se3.quat_mul(se3.quat_conj(got.q.double()), want.q.double()))
    g["q"] = float(torch.linalg.vector_norm(dq)) / ESKF_ANGLE
    cov = want.cov.double()
    d = torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0))
    tol = ESKF_COV_ATOL + ESKF_COV_RTOL * torch.outer(d, d)
    g["cov"] = float(torch.max(torch.abs(got.cov.double() - cov) / tol))
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    return g if finite else {k: float("inf") for k in g}


def eskf_plain(state, gyro, acc, dt, config):
    """The ESKF kernel's plain version: ``eskf_run``'s final state without
    corrections."""
    from lmsf_slam_tpu_torch.estimator.eskf import eskf_run

    return eskf_run(state, gyro, acc, dt, None, None, config=config)[0]


def eskf_window(n, seed):
    """(gyro (n,3), acc (n,3), dts (n,)) float32 numpy: a turning, braking
    100 Hz IMU with noise, for the ESKF kernel's checks."""
    g = np.random.default_rng(seed)
    gyro = g.normal(scale=0.05, size=(n, 3)) + [0.01, -0.02, 0.3]
    acc = g.normal(scale=0.2, size=(n, 3)) + [-0.8, 0.1, 9.81]
    dts = np.full(n, 0.01) + g.uniform(-1e-4, 1e-4, n)
    return tuple(np.asarray(x, np.float32) for x in (gyro, acc, dts))


def eskf_start(offset, device="cpu"):
    """The filter's initial state moving at 8 m/s, and with ``offset`` turned
    by 0.4 rad about a tilted axis with biases of a few hundredths."""
    import torch

    from lmsf_slam_tpu_torch.common import se3
    from lmsf_slam_tpu_torch.estimator.eskf import eskf_init_state

    st = eskf_init_state(device=device)
    st = st._replace(v=torch.tensor([8.0, 0.5, 0.0], device=device))
    if offset:
        st = st._replace(q=se3.so3_exp_quat(torch.tensor([0.1, -0.2, 0.4], device=device)),
                         ba=torch.tensor([0.03, -0.02, 0.05], device=device),
                         bg=torch.tensor([-0.004, 0.002, 0.003], device=device))
    return st
