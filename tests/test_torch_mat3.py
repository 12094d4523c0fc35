"""The port's analytic 3×3 eigen-solver and unrolled 6×6 Cholesky against the
reference (``lmsf_slam_tpu/ops/mat3.py``), on the same numpy inputs.

Tolerances: eigenvalues rtol 1e-5 plus 1e-6·‖A‖ absolute where the
eigenvalue is separated from its neighbours by more than 1e-3·‖A‖. Inside a
(near-)repeated pair — the two small eigenvalues of a line's covariance —
the trigonometric formula evaluates arccos at r ≈ ±1, where its error grows
to ~√ε: there both packages scatter by up to ~6e-4·‖A‖ around the true
value, so the bound is 1e-3·‖A‖. Eigenvectors are compared up to sign and
only where separated (inside a repeated pair they are not defined). The
arithmetic is the same float32 formula; XLA and PyTorch differ in their
sin/cos/arccos by an ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.ops import mat3 as jm
from lmsf_slam_tpu_torch.ops import mat3 as pm
from tests import torch_threads  # noqa: F401


def _psd(kind, n, rng):
    """Batches of symmetric PSD matrices of the association workloads."""
    if kind == "generic":
        X = rng.normal(size=(n, 5, 3))
    elif kind == "line":  # 5 points near a line: rank ~1
        X = rng.normal(size=(n, 5, 1)) * rng.normal(size=(n, 1, 3)) + 1e-3 * rng.normal(size=(n, 5, 3))
    elif kind == "plane":  # rank ~2
        basis = rng.normal(size=(n, 2, 3))
        X = np.einsum("nkb,nbi->nki", rng.normal(size=(n, 5, 2)), basis)
        X += 1e-3 * rng.normal(size=(n, 5, 3))
    elif kind == "isotropic":
        return np.tile(np.eye(3, dtype=np.float32) * 0.7, (n, 1, 1))
    X = X - X.mean(axis=1, keepdims=True)
    return (np.einsum("nki,nkj->nij", X, X) / 5).astype(np.float32)


@pytest.mark.parametrize("kind", ["generic", "line", "plane", "isotropic"])
def test_sym_eigh3_matches_reference(kind):
    seed = ["generic", "line", "plane", "isotropic"].index(kind)
    A = _psd(kind, 500, np.random.default_rng(seed))
    wj, vj = (np.asarray(x) for x in jm.sym_eigh3(jnp.asarray(A)))
    wp, vp = (x.numpy() for x in pm.sym_eigh3(torch.as_tensor(A)))
    scale = np.abs(A).max(axis=(1, 2))[:, None]
    gap_lo = np.concatenate([np.full_like(wj[:, :1], np.inf), np.diff(wj, axis=1)], axis=1)
    gap_hi = np.concatenate([np.diff(wj, axis=1), np.full_like(wj[:, :1], np.inf)], axis=1)
    separated = np.minimum(gap_lo, gap_hi) > 1e-3 * scale
    bound = 1e-5 * np.abs(wj) + np.where(separated, 1e-6, 1e-3) * scale
    for w in (wp, pm.sym_eigvals3(torch.as_tensor(A)).numpy()):
        err = np.abs(w - wj) - bound
        assert np.all(err <= 0), (kind, float(err.max()), float(np.abs(w - wj).max()))
    dots = np.abs(np.einsum("nik,nik->nk", vj, vp))  # columns, sign-free
    assert np.all(dots[separated] > 1 - 1e-4), dots[separated].min()
    # every returned frame is orthonormal
    np.testing.assert_allclose(
        np.einsum("nki,nkj->nij", vp, vp), np.tile(np.eye(3), (len(A), 1, 1)), atol=1e-5
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chol_solve6_matches_reference(seed):
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(40, 6)) * np.array([1, 10, 100, 1, 0.1, 3])
    H = (J.T @ J + 1e-2 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    want = np.asarray(jm.chol_solve6(jnp.asarray(H), jnp.asarray(b)))
    got = pm.chol_solve6(torch.as_tensor(H), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(H.astype(np.float64) @ got, b, rtol=0, atol=1e-3 * np.abs(b).max())
