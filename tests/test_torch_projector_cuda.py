"""The degeneracy projector kernel (``lmsf_slam_tpu_torch/csrc/projector.cu``)
against its plain version, ``projector_plain`` (``torch.linalg.eigh``), on
the card: equal counts of constrained directions, NaN where the normal
matrix is not finite, projectors within 1e-9, P = I exactly where the screen
passed, and the screen decisions and sweeps of its CPU model
(``projector_jacobi_plain``) (see ``kernel_cases.compare_projector``): on
random normal matrices, on each of its two paths and on the boundary batch.

Marked ``cuda``: it skips without a card. This file imports no JAX:

    python -m pytest tests/test_torch_projector_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

import kernel_cases
from lmsf_slam_tpu_torch.ops import projector as pj
from lmsf_slam_tpu_torch.ops.registration import RegistrationParams


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the projector kernel runs only on one")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,axis", [(1, None), (1, 3), (4096, None), (4096, 1)])
def test_kernel_matches_plain_on_card(B, axis):
    dev = _card()
    g = np.random.default_rng(B + (axis or 0))
    J = g.standard_normal((B, 80, 6))
    if axis is not None:
        J[:, :, axis] *= 1e-3
    H = torch.as_tensor(np.einsum("bki,bkj->bij", J, J) * g.uniform(1, 400, (B, 1, 1)),
                        dtype=torch.float32, device=dev)
    n = torch.as_tensor(g.integers(50, 4000, B), dtype=torch.int32, device=dev)
    if B == 1:
        H, n = H[0], n[0]
    kernel_cases.compare_projector(pj, H, n, RegistrationParams())  # raises on a disagreement


@pytest.mark.cuda
def test_non_finite_and_absolute_floor_on_card():
    dev = _card()
    H = torch.eye(6, device=dev) * 500.0
    H[1, 4] = float("nan")
    kernel_cases.compare_projector(pj, H, torch.tensor(100, dtype=torch.int32, device=dev),
                                   RegistrationParams())
    P, n = pj.projector_cuda(H, None, 1e-4, 0.01, 100.0)
    assert int(n) == 0 and bool(torch.isnan(P).all())
    kernel_cases.compare_projector(pj, torch.eye(6, device=dev) * 500.0, None,
                                   RegistrationParams())


@pytest.mark.cuda
def test_each_path_on_card():
    """A well-conditioned normal matrix takes the screen (P = I, 0 sweeps), a
    corridor the Jacobi path (at least one sweep)."""
    dev = _card()
    g = np.random.default_rng(7)
    J = g.standard_normal((2, 80, 6))
    J[1, :, 2] *= 1e-3
    H = torch.as_tensor(np.einsum("bki,bkj->bij", J, J) * 50.0, dtype=torch.float32, device=dev)
    n = torch.tensor([80, 80], dtype=torch.int32, device=dev)
    _, sweeps, screened = kernel_cases.compare_projector(pj, H, n, RegistrationParams())
    assert screened.tolist() == [True, False]
    assert int(sweeps[0]) == 0 and int(sweeps[1]) >= 1
    P, c = pj.projector_cuda(H, n, 1e-4, 0.01, 100.0)
    assert torch.equal(P[0], torch.eye(6, dtype=torch.float64, device=dev)) and c.tolist() == [6, 5]


@pytest.mark.cuda
@pytest.mark.parametrize("name", kernel_cases.PROJECTOR_BOUNDARY)
def test_boundary_batch_on_card(name):
    dev = _card()
    H, n, params = kernel_cases.projector_boundary_cases(dev)[name]
    # the eigenvalues are the diagonal, exactly: the plain version on the CPU
    # (LAPACK) and the exact count, not cuSOLVER's last bit at the tie
    _, _, screened = kernel_cases.compare_projector(pj, H, n, params, plain_on_cpu=True)
    assert tuple(screened.tolist()) == kernel_cases.PROJECTOR_BOUNDARY_SCREENED
    _, n_con = pj.projector_cuda(H, n, params.damping, params.degen_rel, params.degen_thresh)
    assert torch.equal(n_con, kernel_cases.projector_exact_count(H, n, params))
