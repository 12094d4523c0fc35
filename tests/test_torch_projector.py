"""The registration's degeneracy projector (``lmsf_slam_tpu_torch.ops.projector``)
on the CPU: the plain version against the reference's
``lmsf_slam_tpu/ops/registration.py::_degeneracy_projector`` on the same
numpy normal matrices, and the plain model of the CUDA kernel
(``projector_jacobi_plain``: the screen, then the round-robin Jacobi) against
the plain version, on random normal matrices and on the boundary batch of
``chip_smoke.projector_boundary_cases`` (diagonal matrices, exact in float32,
whose smallest eigenvalue lies at, just under and just over the float32
rounding midpoint above the floor).

Tolerances: against the reference, equal counts of constrained directions
and projectors to 1e-5 (the reference decomposes in float32, whose
eigenvectors carry ~1e-6 of rounding); the kernel's model against
``torch.linalg.eigh``, both in float64, equal counts and projectors to 1e-12;
where the model screens, P equal to the identity exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lmsf_slam_tpu.ops import registration as jr
from lmsf_slam_tpu_torch.ops import projector as pj
from lmsf_slam_tpu_torch.ops import registration as tr

PARAMS = tr.RegistrationParams()
ARGS = (PARAMS.damping, PARAMS.degen_rel, PARAMS.degen_thresh)


def normal_matrices(seed, B, degenerate_axis=None):
    """(B,6,6) float32 JᵀJ of random Jacobians with 80 rows, scaled by 1–400,
    and (B,) match counts; with ``degenerate_axis`` that direction is
    scaled by 1e-3 (a corridor), so it falls under the floor."""
    g = np.random.default_rng(seed)
    J = g.standard_normal((B, 80, 6))
    if degenerate_axis is not None:
        J[:, :, degenerate_axis] *= 1e-3
    H = np.einsum("bki,bkj->bij", J, J) * g.uniform(1, 400, (B, 1, 1))
    return H.astype(np.float32), g.integers(50, 4000, B).astype(np.int32)


@pytest.mark.parametrize("seed,axis,relative", [(0, None, True), (1, 2, True), (2, 4, True),
                                                (3, None, False), (4, 0, False)])
def test_plain_matches_reference(seed, axis, relative):
    H, n = normal_matrices(seed, 6, axis)
    for b in range(len(H)):
        nm = jnp.asarray(n[b]) if relative else None
        P_ref, c_ref = jr._degeneracy_projector(jnp.asarray(H[b]), jr.RegistrationParams(), nm)
        P, c = pj.projector_plain(torch.as_tensor(H[b]),
                                  torch.as_tensor(n[b]) if relative else None, *ARGS)
        assert int(c) == int(c_ref)
        np.testing.assert_allclose(P.numpy(), np.asarray(P_ref), atol=1e-5)


@pytest.mark.parametrize("seed,axis", [(10, None), (11, 1), (12, 3), (13, 5)])
def test_jacobi_model_matches_eigh(seed, axis):
    H, n = normal_matrices(seed, 64, axis)
    H, n = torch.as_tensor(H), torch.as_tensor(n)
    P_ref, c_ref = pj.projector_plain(H, n, *ARGS)
    P, c, sweeps = pj.projector_jacobi_plain(H, n, *ARGS, screen=False)
    assert torch.equal(c, c_ref)
    torch.testing.assert_close(P, P_ref, rtol=0, atol=1e-12)
    assert 1 <= int(sweeps.min()) and int(sweeps.max()) <= 10  # quadratic convergence


@pytest.mark.parametrize("case", ["non_finite", "isotropic", "zero", "absolute_floor"])
def test_jacobi_model_corner_cases(case):
    H, n = normal_matrices(20, 1)
    H, n = torch.as_tensor(H), torch.as_tensor(n)
    if case == "non_finite":
        H[0, 2, 3] = float("inf")
    elif case == "isotropic":
        H = torch.eye(6)[None] * 1000.0
    elif case == "zero":
        H = torch.zeros((1, 6, 6))
    nm = None if case == "absolute_floor" else n
    P_ref, c_ref = pj.projector_plain(H, nm, *ARGS)
    P, c, sweeps = pj.projector_jacobi_plain(H, nm, *ARGS)
    assert torch.equal(c, c_ref)
    assert torch.equal(torch.isnan(P), torch.isnan(P_ref))
    torch.testing.assert_close(torch.nan_to_num(P), torch.nan_to_num(P_ref), rtol=0, atol=1e-12)
    if case in ("non_finite", "isotropic", "zero"):  # diagonal already: nothing to rotate
        assert int(sweeps[0]) == 0
    if case == "non_finite":
        assert int(c[0]) == 0 and bool(torch.isnan(P).all())


@pytest.mark.parametrize("seed,axis", [(40, None), (41, 2), (42, 5)])
def test_screen_passes_only_clear_matrices(seed, axis):
    """With the screen the model still equals ``eigh``: P = I exactly, 6
    directions and 0 sweeps where it screens, which is every matrix without a
    degenerate direction and none with one; elsewhere the Jacobi path."""
    H, n = normal_matrices(seed, 64, axis)
    H, n = torch.as_tensor(H), torch.as_tensor(n)
    P_ref, c_ref = pj.projector_plain(H, n, *ARGS)
    P, c, sweeps = pj.projector_jacobi_plain(H, n, *ARGS)
    screened = pj.projector_screen_plain(H, n, *ARGS)
    assert torch.equal(c, c_ref)
    torch.testing.assert_close(P, P_ref, rtol=0, atol=1e-12)
    assert bool(screened.all()) if axis is None else not bool(screened.any())
    assert torch.equal(P[screened], torch.eye(6, dtype=torch.float64).expand(int(screened.sum()),
                                                                             6, 6))
    assert bool((c[screened] == 6).all()) and bool((sweeps[screened] == 0).all())
    assert bool((sweeps[~screened] >= 1).all())


@pytest.mark.parametrize("name", chip_smoke.PROJECTOR_BOUNDARY)
def test_screen_at_the_floor(name):
    """The boundary batch: the model's counts equal ``eigh``'s, it screens
    exactly the matrices clear of the floor (never one whose smallest
    eigenvalue rounds to the floor or under, never a non-finite one), and
    gives P = I exactly where it screens."""
    H, n, params = chip_smoke.projector_boundary_cases("cpu")[name]
    args = (params.damping, params.degen_rel, params.degen_thresh)
    P_ref, c_ref = pj.projector_plain(H, n, *args)
    P, c, sweeps = pj.projector_jacobi_plain(H, n, *args)
    screened = pj.projector_screen_plain(H, n, *args)
    assert torch.equal(c, c_ref)
    assert torch.equal(torch.isnan(P), torch.isnan(P_ref))
    torch.testing.assert_close(torch.nan_to_num(P), torch.nan_to_num(P_ref), rtol=0, atol=1e-12)
    assert tuple(screened.tolist()) == chip_smoke.PROJECTOR_BOUNDARY_SCREENED
    assert torch.equal(P[screened], torch.eye(6, dtype=torch.float64).expand(2, 6, 6))
    assert bool((c[screened] == 6).all()) and bool((sweeps == 0).all())  # diagonal
    # the eigenvalues of a diagonal A are its entries, exact: the smallest of
    # the first two sits at the midpoint, so float32 rounds it to the floor or
    # one step over, as the offset and the floor's last bit say
    exact = chip_smoke.projector_exact_count(H, n, params)
    assert torch.equal(c, exact)
    floor = np.float32(params.degen_thresh) if n is None else (
        np.float32(params.degen_rel) * np.float32(n[0].item()))
    offset = name.split(", ")[1].split()[0]
    odd = int(floor.view(np.int32)) & 1  # a tie rounds to the even neighbour
    rounds_up = offset == "over" or (offset == "at" and odd == 1)
    assert exact[:2].tolist() == [6 if rounds_up else 5] * 2
    assert int(c[4]) == 0 and not bool(screened[4])


@pytest.mark.parametrize("B,screened", [(1, 1), (1, 0), (4096, 3072), (4096, 0)])
def test_bound_counts_the_function_not_the_sweeps(B, screened):
    """``chip_smoke.projector_bound_ms`` counts what the function needs (a
    proof for a screened matrix, a 6x6 eigendecomposition and P for the
    others), whatever sweeps the kernel took: at these sizes that is under
    the bytes, so the bound is H and the count read once, P and the count
    written once."""
    ms, by = chip_smoke.projector_bound_ms(B, screened)
    ops = (chip_smoke.PROJECTOR_SCREEN_OPS * screened
           + chip_smoke.PROJECTOR_EIGH_OPS * (B - screened))
    assert ops / chip_smoke.PEAK_FP64_FLOPS * 1e3 < ms
    assert by == "bytes" and ms == pytest.approx(B * 440 / chip_smoke.PEAK_BYTES_PER_S * 1e3)


def test_registration_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the registration's projector is ``projector_plain``
    bit for bit; the kernel's wrapper refuses a CPU tensor."""
    H, n = normal_matrices(30, 1, 2)
    H, n = torch.as_tensor(H[0]), torch.as_tensor(n[0])
    P, c = tr._degeneracy_projector(H, PARAMS, n)
    P_ref, c_ref = pj.projector_plain(H, n, *ARGS)
    assert torch.equal(P, P_ref) and torch.equal(c, c_ref) and int(c) == 5
    with pytest.raises(ValueError, match="CUDA"):
        pj.projector_cuda(H, n, *ARGS)
